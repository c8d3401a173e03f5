"""The port's MoE layer against the reference's (tests/test_models.py's
MoE cases through both packages).

Parameters come from the reference's ``init_moe`` (carried across by
``core.convert.load_tree``), inputs from numpy seeds; outputs and the
aux statistics are held within 1e-4 * max(1, max |reference|), and the
dispatch's integers (``expert_idx``, ``sorted_expert``,
``sorted_token``, ``safe_rank``, ``keep``) bitwise: with headroom, with
drops, with tied router probabilities, and on the grouped, chunked path
(B * S > 16384). On the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.common import ParallelCtx
from repro_torch.core.convert import load_tree
from repro_torch.models import moe as tmoe

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


def _moe_pair(seed, d, ff, e, shared, gated=True):
    params = _np(jmoe.init_moe(jax.random.PRNGKey(seed), d, ff, e, shared,
                               gated, jnp.float32))
    return params, load_tree(tmoe.MoE(d, ff, e, shared, gated,
                                      torch.float32, "cpu"), params)


def _same_dispatch(params, p, x, k, c):
    """The dispatch's integers bitwise the reference's, its buckets and
    gates within tolerance."""
    xt = x.reshape(-1, x.shape[-1])
    want = jmoe._dispatch_group(params, jnp.asarray(xt), k=k, c=c,
                                act_name="silu", rng=None, router_jitter=0.0)
    got = tmoe._dispatch_group(p, torch.from_numpy(xt), k=k, c=c)
    probs = jax.nn.softmax(jnp.asarray(xt) @ params["router"], axis=-1)
    idx = np.asarray(jax.lax.top_k(probs, k)[1])
    np.testing.assert_array_equal(got.expert_idx.numpy(), idx)
    (buckets, se, st, sg, sr, keep, lb, rz) = want
    for name, w in (("sorted_expert", se), ("sorted_token", st),
                    ("safe_rank", sr), ("keep", keep)):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(w), err_msg=name)
    _close(got.buckets, buckets)
    _close(got.sorted_gate, sg)
    _close(got.lb, lb)
    _close(got.rz, rz)
    return got


@pytest.mark.parametrize("k", [1, 2])
def test_moe_matches_reference_with_headroom(k):
    """With capacity_factor high enough to avoid drops, sort-based
    dispatch equals the dense gather oracle."""
    d, ff, e = 16, 32, 4
    params, p = _moe_pair(0, d, ff, e, 0)
    x = np.random.default_rng(k).normal(0, 1, (2, 8, d)).astype(np.float32)
    got, aux = tmoe.moe_mlp(p, torch.from_numpy(x), experts_per_token=k,
                            act_name="silu", capacity_factor=float(e))
    want, waux = jmoe.moe_mlp(params, jnp.asarray(x), experts_per_token=k,
                              act_name="silu", ctx=CTX,
                              capacity_factor=float(e))
    _close(got, want)
    _close(aux["load_balance"], waux["load_balance"])
    _close(aux["router_z"], waux["router_z"])
    oracle = tmoe.moe_mlp_reference(p, torch.from_numpy(x),
                                    experts_per_token=k, act_name="silu")
    _close(oracle, jmoe.moe_mlp_reference(params, jnp.asarray(x),
                                          experts_per_token=k,
                                          act_name="silu"))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=2e-4,
                               atol=2e-4)
    _same_dispatch(params, p, x, k, tmoe.capacity(16, e, k, float(e)))


def test_moe_drops_as_the_reference():
    """At capacity factor 0.5, 32 tokens top-2 over 4 experts overflow:
    the dropped entries, their clamped slot and the outputs match."""
    d, ff, e, k = 16, 32, 4, 2
    params, p = _moe_pair(4, d, ff, e, 0)
    x = np.random.default_rng(11).normal(0, 1, (1, 32, d)).astype(np.float32)
    c = tmoe.capacity(32, e, k, 0.5)
    assert c == jmoe.capacity(32, e, k, 0.5) == 8
    disp = _same_dispatch(params, p, x, k, c)
    assert not bool(disp.keep.all())
    got, _ = tmoe.moe_mlp(p, torch.from_numpy(x), experts_per_token=k,
                          act_name="silu", capacity_factor=0.5)
    want, _ = jmoe.moe_mlp(params, jnp.asarray(x), experts_per_token=k,
                           act_name="silu", ctx=CTX, capacity_factor=0.5)
    _close(got, want)


def test_moe_shared_expert():
    d, ff, e = 8, 16, 4
    params, p = _moe_pair(3, d, ff, e, 1)
    x = np.random.default_rng(4).normal(0, 1, (1, 6, d)).astype(np.float32)
    got, _ = tmoe.moe_mlp(p, torch.from_numpy(x), experts_per_token=1,
                          act_name="silu", capacity_factor=float(e))
    want, _ = jmoe.moe_mlp(params, jnp.asarray(x), experts_per_token=1,
                           act_name="silu", ctx=CTX,
                           capacity_factor=float(e))
    _close(got, want)
    oracle = tmoe.moe_mlp_reference(p, torch.from_numpy(x),
                                    experts_per_token=1, act_name="silu")
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_moe_load_balance_uniform_router():
    """A zero router routes uniformly (load balance ~= 1), and every
    token's probabilities tie: top-k takes the lowest expert ids, as
    lax.top_k does, and the dispatch follows bitwise."""
    d, ff, e = 8, 16, 8
    params, p = _moe_pair(0, d, ff, e, 0)
    params = dict(params, router=np.zeros((d, e), np.float32))
    with torch.no_grad():
        p.router.zero_()
    x = np.random.default_rng(1).normal(0, 1, (1, 512, d)).astype(np.float32)
    got, aux = tmoe.moe_mlp(p, torch.from_numpy(x), experts_per_token=2,
                            act_name="silu")
    want, waux = jmoe.moe_mlp(params, jnp.asarray(x), experts_per_token=2,
                              act_name="silu", ctx=CTX)
    assert 0.9 < float(aux["load_balance"]) < 1.1
    _close(aux["load_balance"], waux["load_balance"])
    _close(got, want)
    disp = _same_dispatch(params, p, x, 2, tmoe.capacity(512, e, 2))
    assert set(disp.expert_idx.unique().tolist()) == {0, 1}


def test_moe_groups_and_chunks_as_the_reference():
    """B * S > 16384 with B > 1: one group a batch row, S = 12,288 cut in
    three 4,096-token chunks, each with its own capacity."""
    d, ff, e = 8, 8, 4
    params, p = _moe_pair(2, d, ff, e, 0, gated=False)
    x = np.random.default_rng(3).normal(0, 1, (2, 12288, d)).astype(
        np.float32)
    got, aux = tmoe.moe_mlp(p, torch.from_numpy(x), experts_per_token=1,
                            act_name="gelu")
    want, waux = jmoe.moe_mlp(params, jnp.asarray(x), experts_per_token=1,
                              act_name="gelu", ctx=CTX)
    _close(got, want)
    _close(aux["load_balance"], waux["load_balance"])
    _close(aux["router_z"], waux["router_z"])


def test_moe_router_jitter_is_training_only():
    """Jitter draws only from a given generator: the same seed draws the
    same noise, rng=None (prefill and decode) draws nothing and equals the
    jitter-free call bitwise."""
    params, p = _moe_pair(0, 8, 16, 4, 0)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (1, 16, 8)).astype(np.float32))
    kw = dict(experts_per_token=1, act_name="silu")
    plain, _ = tmoe.moe_mlp(p, x, router_jitter=0.0, **kw)
    none, _ = tmoe.moe_mlp(p, x, router_jitter=1.0, rng=None, **kw)
    assert torch.equal(none, plain)
    a, aux_a = tmoe.moe_mlp(p, x, router_jitter=1.0,
                            rng=torch.Generator().manual_seed(5), **kw)
    b, aux_b = tmoe.moe_mlp(p, x, router_jitter=1.0,
                            rng=torch.Generator().manual_seed(5), **kw)
    assert torch.equal(a, b)
    assert torch.equal(aux_a["router_z"], aux_b["router_z"])
    assert not torch.equal(aux_a["router_z"],
                           tmoe.moe_mlp(p, x, router_jitter=0.0,
                                        **kw)[1]["router_z"])


@pytest.mark.parametrize("tokens,e,k,cf", [(1, 128, 8, 1.25),
                                           (24, 4, 2, 64.0),
                                           (4096, 128, 1, 1.25)])
def test_capacity_matches_reference(tokens, e, k, cf):
    assert tmoe.capacity(tokens, e, k, cf) == jmoe.capacity(tokens, e, k, cf)
