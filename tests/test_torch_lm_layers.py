"""The port's LM layers against the reference's (tests/test_models.py's
cases through both packages).

Every case makes its inputs with numpy from a seed, draws the layer's
parameters with the reference's initialiser and carries them across
with ``core.convert.load_tree``, runs the reference's function and the
port's on the same inputs, and holds the port to the reference within
1e-4 * max(1, max |reference|) (float32; sums in another order). The
reference's own checks (flash against full, local against band-masked
full, decode against full, SSD chunked against sequential, RG-LRU scan
against sequential) run again on the port at the reference's
tolerances; the MoE cases are in tests/test_torch_lm_moe.py. Everything
runs on the CPU, where ``attention.flash_attention`` is the kernel's
plain version.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import attention as JA
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import rglru as jrg
from repro.models import ssm as jssm
from repro.models.common import ParallelCtx
from repro_torch.configs.base import ModelConfig
from repro_torch.core.convert import load_tree
from repro_torch.models import attention as TA
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import rglru as trg
from repro_torch.models import ssm as tssm

CTX = ParallelCtx()


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


def _qkv(rng, b, s, hq, hkv, d):
    return (rng.normal(0, 1, (b, s, hq, d)).astype(np.float32),
            rng.normal(0, 1, (b, s, hkv, d)).astype(np.float32),
            rng.normal(0, 1, (b, s, hkv, d)).astype(np.float32))


def _both(*arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a) for a in arrs])


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (4, 1)])
def test_flash_matches_full(hq, hkv):
    j, t = _both(*_qkv(np.random.default_rng(0), 2, 256, hq, hkv, 16))
    want_full = JA.full_attention(*j, causal=True)
    want = JA.flash_attention(*j, causal=True, q_chunk=64, kv_chunk=64)
    full = TA.full_attention(*t, causal=True)
    got = TA.flash_attention(*t, causal=True, q_chunk=64, kv_chunk=64)
    _close(full, want_full)
    _close(got, want)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_flash_routes_as_the_reference():
    """Chunks that do not divide S take full_attention in both packages;
    a head dim the kernel does not take raises on the flash branch."""
    j, t = _both(*_qkv(np.random.default_rng(5), 1, 96, 4, 2, 16))
    _close(TA.flash_attention(*t, q_chunk=64, kv_chunk=64),
           JA.flash_attention(*j, q_chunk=64, kv_chunk=64))
    _, t = _both(*_qkv(np.random.default_rng(6), 1, 64, 2, 1, 256))
    with pytest.raises(ValueError, match="head dim 256"):
        TA.flash_attention(*t)


@pytest.mark.parametrize("window", [32, 64])
def test_local_matches_full_with_window_mask(window):
    j, t = _both(*_qkv(np.random.default_rng(2), 1, 256, 4, 1, 8))
    want = JA.local_attention(*j, window=window)
    got = TA.local_attention(*t, window=window)
    _close(got, want)
    band = TA.full_attention(*t, causal=True, window=window)
    _close(band, JA.full_attention(*j, causal=True, window=window))
    np.testing.assert_allclose(got.numpy(), band.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("s", [24, 32])    # 24: s <= 32, the band route
def test_local_falls_back_as_the_reference(s):
    j, t = _both(*_qkv(np.random.default_rng(s), 2, s, 4, 2, 8))
    _close(TA.local_attention(*t, window=32),
           JA.local_attention(*j, window=32))


def test_decode_matches_full_last_position():
    b, s, hq, hkv, d = 2, 64, 4, 2, 8
    q, k, v = _qkv(np.random.default_rng(3), b, s, hq, hkv, d)
    j, t = _both(q[:, -1:].copy(), k, v)
    want = JA.decode_attention(*j, jnp.asarray(s - 1))
    got = TA.decode_attention(*t, s - 1)
    _close(got, want)
    full = TA.full_attention(*_both(q, k, v)[1], causal=True)
    np.testing.assert_allclose(got.numpy()[:, 0], full.numpy()[:, -1],
                               rtol=2e-4, atol=2e-4)
    # a shorter valid prefix masks the rest, as the reference's does
    _close(TA.decode_attention(*t, 20),
           JA.decode_attention(*j, jnp.asarray(20)))


def test_full_attention_q_offset():
    q, k, v = _qkv(np.random.default_rng(4), 1, 48, 4, 2, 8)
    j, t = _both(q[:, -8:].copy(), k, v)
    _close(TA.full_attention(*t, q_offset=40),
           JA.full_attention(*j, q_offset=40))


def test_rope_matches_reference():
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 12, 4, 32)).astype(np.float32)
    for pos in (np.arange(12), np.stack([np.arange(12), np.arange(5, 17)])):
        want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5)
        got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                 5e5)
        _close(got, want)
    _close(tcommon.rope_frequencies(64, 1e4),
           jcommon.rope_frequencies(64, 1e4))


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------

@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False),
                                       ("relu2", False), ("gelu", True)])
def test_mlp_matches_reference(act, gated):
    params = _np(jmlp.init_mlp(jax.random.PRNGKey(1), 16, 40, gated,
                               jnp.float32))
    p = load_tree(tmlp.MLP(16, 40, gated, torch.float32, "cpu"), params)
    x = np.random.default_rng(8).normal(0, 1, (2, 5, 16)).astype(np.float32)
    _close(tmlp.mlp(p, torch.from_numpy(x), act),
           jmlp.mlp(params, jnp.asarray(x), act, CTX))


# ----------------------------------------------------------------------
# SSM (mamba2 / SSD)
# ----------------------------------------------------------------------

SSM_CFG = dict(name="t", family="ssm", num_layers=1, d_model=32,
               vocab_size=64, ssm_state=8, ssm_expand=2, ssm_head_dim=16,
               ssm_chunk=8, ssm_conv_width=4)


def _ssd_pair(seed=0):
    jc, tc = JModelConfig(**SSM_CFG), ModelConfig(**SSM_CFG)
    params = _np(jssm.init_ssd(jax.random.PRNGKey(seed), jc, jnp.float32))
    return jc, tc, params, load_tree(tssm.SSD(tc, torch.float32, "cpu"),
                                     params)


def _jstate(st):
    return jssm.SSMState(jnp.asarray(st.conv.numpy()),
                         jnp.asarray(st.ssd.numpy()))


@pytest.mark.parametrize("s", [16, 24])   # 24: not a chunk multiple
def test_ssd_chunked_matches_sequential(s):
    jc, tc, params, p = _ssd_pair()
    x = np.random.default_rng(s).normal(0, 1, (2, s, 32)).astype(np.float32)
    xt = torch.from_numpy(x)
    st0 = tssm.init_ssm_state(tc, 2, torch.float32, "cpu")
    y, st = tssm.ssd_forward(p, xt, tc, st0)
    wy, wst = jssm.ssd_forward(params, jnp.asarray(x), jc, CTX,
                               jssm.init_ssm_state(jc, 2, jnp.float32))
    _close(y, wy)
    _close(st.ssd, wst.ssd)
    _close(st.conv, wst.conv)
    # the reference's own check, on the port: the decode step as oracle
    seq = tssm.init_ssm_state(tc, 2, torch.float32, "cpu")
    outs = []
    for t in range(s):
        yt, seq = tssm.ssd_decode_step(p, xt[:, t:t + 1], tc, seq)
        outs.append(yt)
    np.testing.assert_allclose(y.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(st.ssd.numpy(), seq.ssd.numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(st.conv.numpy(), seq.conv.numpy(),
                               rtol=1e-4, atol=1e-5)
    # train mode (no state) gives the same y and no state
    y2, none = tssm.ssd_forward(p, xt, tc, None)
    assert none is None
    _close(y2, wy)


def test_ssd_decode_continues_prefill():
    jc, tc, params, p = _ssd_pair()
    x = np.random.default_rng(2).normal(0, 1, (1, 12, 32)).astype(np.float32)
    xt = torch.from_numpy(x)
    full, _ = tssm.ssd_forward(p, xt, tc,
                               tssm.init_ssm_state(tc, 1, torch.float32,
                                                   "cpu"))
    pre, st = tssm.ssd_forward(p, xt[:, :8], tc,
                               tssm.init_ssm_state(tc, 1, torch.float32,
                                                   "cpu"))
    outs = [pre]
    for t in range(8, 12):
        want, _ = jssm.ssd_decode_step(params, jnp.asarray(x[:, t:t + 1]),
                                       jc, CTX, _jstate(st))
        y, st = tssm.ssd_decode_step(p, xt[:, t:t + 1], tc, st)
        _close(y, want)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


# ----------------------------------------------------------------------
# RG-LRU
# ----------------------------------------------------------------------

LRU_CFG = dict(name="t", family="hybrid", num_layers=1, d_model=16,
               vocab_size=64, num_heads=2, num_kv_heads=1, d_ff=32,
               lru_width=16, attn_period=3, local_window=8)


@pytest.mark.parametrize("s", [10, 33])
def test_rglru_scan_matches_sequential(s):
    jc, tc = JModelConfig(**LRU_CFG), ModelConfig(**LRU_CFG)
    params = _np(jrg.init_rglru(jax.random.PRNGKey(0), jc, jnp.float32))
    p = load_tree(trg.RGLRU(tc, torch.float32, "cpu"), params)
    x = np.random.default_rng(s).normal(0, 1, (2, s, 16)).astype(np.float32)
    xt = torch.from_numpy(x)
    st0 = trg.init_lru_state(tc, 2, torch.float32, "cpu")
    y, st = trg.rglru_forward(p, xt, tc, st0)
    wy, wst = jrg.rglru_forward(params, jnp.asarray(x), jc, CTX,
                                jrg.init_lru_state(jc, 2, jnp.float32))
    _close(y, wy)
    _close(st.h, wst.h)
    _close(st.conv, wst.conv)
    seq = st0
    outs = []
    for t in range(s):
        yt, seq = trg.rglru_decode_step(p, xt[:, t:t + 1], tc, seq)
        outs.append(yt)
    np.testing.assert_allclose(y.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st.h.numpy(), seq.h.numpy(), rtol=2e-4,
                               atol=2e-4)
    # a nonzero incoming state, as a chunked prefill would carry
    h0 = np.random.default_rng(1).normal(0, 1, (2, 16)).astype(np.float32)
    c0 = np.random.default_rng(2).normal(0, 1, (2, 3, 16)).astype(np.float32)
    got, gst = trg.rglru_forward(p, xt, tc, trg.LRUState(
        torch.from_numpy(c0), torch.from_numpy(h0)))
    want, wst = jrg.rglru_forward(params, jnp.asarray(x), jc, CTX,
                                  jrg.LRUState(jnp.asarray(c0),
                                               jnp.asarray(h0)))
    _close(got, want)
    _close(gst.h, wst.h)


def test_linear_scan_matches_a_loop():
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, (2, 37, 5)).astype(np.float32))
    pa, h = trg.linear_scan(a, b)
    hh, acc = torch.zeros(2, 5), torch.ones(2, 5)
    for t in range(37):
        hh = a[:, t] * hh + b[:, t]
        acc = acc * a[:, t]
        np.testing.assert_allclose(h[:, t].numpy(), hh.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(pa[:, t].numpy(), acc.numpy(), rtol=1e-5,
                                   atol=1e-6)
