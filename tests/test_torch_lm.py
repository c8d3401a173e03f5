"""The port's LM serving path against the reference's, for all ten
assigned architectures at their reduced configs.

Configs: ``get_config`` / ``get_reduced_config`` of every id equal the
reference's field for field (``dataclasses.asdict``), with the same
``param_count``, ``active_param_count``, ``scan_pattern`` and
``layer_kinds`` (tests/test_arch_smoke.py's config tests, twinned), and
the launchers' defaults equal. The port's ``init_params`` builds the
reference's tree, name for name, shape for shape and dtype for dtype,
with the reference's distributions.

Each architecture's reference parameters (``repro.models.lm.init_params``)
cross over by ``core.convert.lm_from_numpy``; on the same seeded numpy
inputs the port's ``prefill`` (last logits and every cache), four
``decode_step``s after ``pad_caches`` (started from the reference's
prefill caches by ``caches_from_numpy``, logits and caches each step) and
``lm_feature_fn`` are held to the reference within 1e-4 * max(1, max
|reference|) (float32; ``ServeConfig(cache_dtype="float32")`` as
tests/test_arch_smoke.py). On the CPU.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ServeConfig as JServeConfig
from repro.features import extract as jextract
from repro.models import lm as jlm
from repro.models.common import ParallelCtx
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ServeConfig
from repro_torch.core.convert import (caches_from_numpy, lm_arrays,
                                      lm_from_numpy)
from repro_torch.features.extract import lm_feature_fn
from repro_torch.models import lm as tlm

CTX = ParallelCtx()
JSV = JServeConfig(cache_dtype="float32")
SV = ServeConfig(cache_dtype="float32")
ARCHS = jconfigs.ASSIGNED_ARCHS
S, T = 24, 4


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
    """The port's per-layer caches against the reference's tree."""
    want = caches_from_numpy(_np(want_tree), cfg, device="cpu")
    assert len(got) == len(want) == cfg.num_layers
    for g, w in zip(got, want):
        assert type(g) is type(w)
        gl = g.values() if isinstance(g, dict) else g
        wl = w.values() if isinstance(w, dict) else w
        for a, b in zip(gl, wl):
            assert a.dtype == b.dtype
            _close(a, b)


def _inputs(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference cfg, port cfg, reference params, the port's LM)."""
    jc = jconfigs.get_reduced_config(arch)
    tc = tconfigs.get_reduced_config(arch)
    params = jlm.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, params, lm_from_numpy(_np(params), tc, device="cpu")


@functools.lru_cache(maxsize=None)
def _prefilled(arch):
    """The reference's prefill of S tokens (batch 2) of the full input."""
    jc, _, params, _ = _pair(arch)
    full = _inputs(jc, 2, S + T)
    logits, caches = jlm.prefill(params, jnp.asarray(full[:, :S]), jc, CTX,
                                 JSV)
    return full, logits, caches


# ----------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_config_matches_reference(arch):
    want, got = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for cw, cg in ((want, got), (jconfigs.get_reduced_config(arch),
                                 tconfigs.get_reduced_config(arch))):
        assert dataclasses.asdict(cg) == dataclasses.asdict(cw)
        assert cg.param_count() == cw.param_count()
        assert cg.active_param_count() == cw.active_param_count()
        assert cg.scan_pattern() == cw.scan_pattern()
        assert cg.layer_kinds() == cw.layer_kinds()
        assert (cg.padded_vocab, cg.kv_dim, cg.d_inner, cg.ssm_heads) == \
            (cw.padded_vocab, cw.kv_dim, cw.d_inner, cw.ssm_heads)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_defaults_match_reference(arch):
    asdict = dataclasses.asdict
    assert [asdict(c) for c in tconfigs.shape_cells(arch)] == \
        [asdict(c) for c in jconfigs.shape_cells(arch)]
    assert asdict(tconfigs.default_train_config(arch)) == \
        asdict(jconfigs.default_train_config(arch))
    for shape in ("train_4k", "decode_32k"):
        for multi in (False, True):
            assert asdict(tconfigs.make_run_config(arch, shape, multi)) == \
                asdict(jconfigs.make_run_config(arch, shape, multi))


def test_registry_matches_reference():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert tconfigs.SUBQUADRATIC_ARCHS == jconfigs.SUBQUADRATIC_ARCHS
    assert [dataclasses.asdict(s) for s in tconfigs.SHAPES] == \
        [dataclasses.asdict(s) for s in jconfigs.SHAPES]
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("no-such-arch")


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    """init_params draws the reference's tree: every name, shape and
    dtype, with N(0, 1/fan_in) weights, zero norms, the embedding's
    scale, RG-LRU's Lambda in its range and SSD's fixed A, D, dt."""
    jc, tc, params, _ = _pair(arch)
    model = tlm.init_params(tc, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    want = lm_arrays(_np(params), jc)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, a in want.items():
        assert tuple(got[name].shape) == a.shape, name
        assert str(got[name].dtype).split(".")[1] == a.dtype.name, name
        g = got[name].detach()
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("norm") or leaf in ("final_norm", "conv_b",
                                               "gate_a_b", "gate_x_b"):
            assert not g.any(), name
        elif leaf in ("A_log", "D", "dt_bias"):
            np.testing.assert_allclose(g.numpy(), a, rtol=1e-6, err_msg=name)
        elif leaf == "lam":
            root = torch.sigmoid(g)
            u = root ** 8.0
            assert 0.9 ** 2 - 1e-5 <= u.min() and u.max() <= 0.999 ** 2 + 1e-5
        elif g.numel() >= 4096:
            # the same standard deviation as the reference's draw
            np.testing.assert_allclose(float(g.std()), float(a.std()),
                                       rtol=0.1, err_msg=name)
    again = tlm.init_params(tc, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    for name, p in again.named_parameters():
        assert torch.equal(p, got[name]), name


# ----------------------------------------------------------------------
# prefill, decode, features
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    jc, tc, _, model = _pair(arch)
    full, want, jcaches = _prefilled(arch)
    logits, caches = tlm.prefill(model, full[:, :S], SV)
    assert logits.shape == (2, 1, tc.padded_vocab)
    _close(logits, want)
    _same_caches(caches, jcaches, tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    """pad_caches, then four decode steps from the reference's prefill
    caches, logits and caches each step."""
    jc, tc, params, model = _pair(arch)
    full, _, jcaches = _prefilled(arch)
    caches = caches_from_numpy(_np(jcaches), tc, device="cpu")
    jcaches = jlm.pad_caches(jcaches, jc, S + T)
    caches = tlm.pad_caches(caches, tc, S + T)
    _same_caches(caches, jcaches, tc)
    for t in range(S, S + T):
        tok = full[:, t:t + 1]
        want, jcaches = jlm.decode_step(params, jcaches, jnp.asarray(tok),
                                        jnp.asarray(t), jc, CTX, JSV)
        got, caches = tlm.decode_step(model, caches, tok, t, SV)
        _close(got, want)
    _same_caches(caches, jcaches, tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_feature_fn_matches_reference(arch):
    jc, tc, params, model = _pair(arch)
    x = _inputs(jc, 3, 20, seed=5)
    want = jextract.lm_feature_fn(jc, CTX)(params, jnp.asarray(x))
    got = lm_feature_fn(model)(torch.from_numpy(x))
    assert got.shape == (3, tc.d_model)
    _close(got, want)
