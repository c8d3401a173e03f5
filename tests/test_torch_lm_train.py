"""The port's LM training path against the reference's, for all ten
assigned architectures at their reduced configs (float32).

Reference parameters cross by ``core.convert.lm_from_numpy`` (a whole
reference ``TrainState`` by ``train_state_from_numpy``). On the same
seeded numpy batch:

- ``forward_train``'s loss and metrics (``ce_loss``, ``load_balance``;
  z-loss 1e-4, the MoE load-balance term on) within 1e-5 relative of the
  reference's, and every parameter's gradient (``torch.autograd.grad``
  against ``jax.grad`` of the same loss) within 1e-4 * max(1, max
  |reference gradient|);
- ``loss_chunk`` > 0 against 0 with the z-loss on (the same tolerances,
  and against the reference's chunked loss);
- the flash branch (``flash_at_16`` of tests/test_torch_lm_serve.py: the
  threshold at 16 in both packages): gradients through the port's
  ``ops.flash_attention`` (the plain forward and backward on the CPU),
  within the same tolerance of XLA's gradients of the reference's chunked
  flash;
- ``remat`` none / full / dots: loss and gradients bitwise equal to each
  other on the CPU (router jitter on, so a recompute must draw the same);
- ``make_train_step`` at M = 1 and M = 2: ``loss`` and ``grad_norm``
  within 1e-5 relative of the reference's jitted step, the same metric
  keys, and the new parameters and moments within the gradient
  tolerance carried through Adam's first step (``_step_close``);
- router jitter: the same generator draws the same, another seed
  differs, jitter 0 equals the generator-free run bitwise, and prefill /
  decode never draw.
On the CPU; the ``gpu``-marked case runs one reduced step card against
CPU (``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_lm_train.py``).
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
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models.common import ParallelCtx
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ServeConfig, TrainConfig
from repro_torch.core.convert import (lm_arrays, lm_from_numpy,
                                      train_state_from_numpy)
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from test_torch_lm_serve import flash_at_16  # noqa: F401  (fixture)

CTX = ParallelCtx()
ARCHS = jconfigs.ASSIGNED_ARCHS
B, S = 2, 16
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want) -> float:
    num = lambda x: float(x.detach() if torch.is_tensor(x) else x)
    return abs(num(got) / num(want) - 1.0)


def _grads_close(got: dict, want_tree, cfg, tol=GRAD_TOL):
    want = lm_arrays(_np(want_tree), cfg)
    assert set(got) == set(want)
    for name, g in got.items():
        w = np.asarray(want[name], np.float32)
        err = float(np.abs(g.detach().numpy() - w).max())
        assert err <= tol * max(1.0, float(np.abs(w).max())), (name, err)


def _batch(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        x = rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    else:
        x = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return x, rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, **over):
    jc = jconfigs.get_reduced_config(arch, **over)
    return jc, jlm.init_params(jax.random.PRNGKey(0), jc)


def _pair(arch, **over):
    """(reference cfg, port cfg, reference params, the port's LM with
    grads)."""
    jc, params = _ref_params(arch, **over)
    tc = tconfigs.get_reduced_config(arch, **over)
    model = lm_from_numpy(_np(params), tc, device="cpu")
    return jc, tc, params, model.requires_grad_(True)


def _lb(cfg):
    return cfg.load_balance_coef if cfg.num_experts else 0.0


def _ref_loss_and_grads(jc, params, x, y, **kw):
    def f(p):
        return jlm.forward_train(p, jnp.asarray(x), jnp.asarray(y), jc, CTX,
                                 **kw)
    return jax.jit(jax.value_and_grad(f, has_aux=True))(params)


def _port_loss_and_grads(model, x, y, **kw):
    loss, metrics = tlm.forward_train(model, x, y, **kw)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True, materialize_grads=True)
    return loss, metrics, dict(zip(named, grads))


# ----------------------------------------------------------------------
# forward_train and its gradients
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    jc, tc, params, model = _pair(arch)
    x, y = _batch(jc)
    kw = dict(z_loss=1e-4, lb_coef=_lb(jc))
    (jloss, jmet), jgrads = _ref_loss_and_grads(jc, params, x, y, **kw)
    loss, met, grads = _port_loss_and_grads(model, x, y, **kw)
    assert set(met) == set(jmet) == {"ce_loss", "load_balance"}
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert _rel(loss, jloss) <= LOSS_RTOL
    assert _rel(met["ce_loss"], jmet["ce_loss"]) <= LOSS_RTOL
    if jc.num_experts:
        assert _rel(met["load_balance"], jmet["load_balance"]) <= LOSS_RTOL
    else:
        assert float(met["load_balance"]) == float(jmet["load_balance"]) == 0
    _grads_close(grads, jgrads, tc)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-moe-235b-a22b",
                                  "musicgen-medium"])
def test_loss_chunk_matches_unchunked(arch):
    """Two chunks of 8 against the whole sequence, z-loss on: equal to
    each other and to the reference's chunked loss."""
    jc, tc, params, model = _pair(arch)
    x, y = _batch(jc, seed=1)
    kw = dict(z_loss=1e-4, lb_coef=_lb(jc))
    l0, _, g0 = _port_loss_and_grads(model, x, y, loss_chunk=0, **kw)
    l8, _, g8 = _port_loss_and_grads(model, x, y, loss_chunk=8, **kw)
    (jl8, _), jg8 = _ref_loss_and_grads(jc, params, x, y, loss_chunk=8,
                                        **kw)
    assert _rel(l8, l0) <= LOSS_RTOL and _rel(l8, jl8) <= LOSS_RTOL
    for name, g in g8.items():
        scale = max(1.0, float(g0[name].abs().max()))
        assert float((g - g0[name]).abs().max()) <= GRAD_TOL * scale, name
    _grads_close(g8, jg8, tc)


def test_chunked_loss_masks_the_vocab_padding():
    """A vocab that pads (250 -> 256) masks the pad columns: the loss
    equals the reference's, whose pad logits are -1e30."""
    jc, tc, params, model = _pair("llama3-8b", vocab_size=250)
    assert tc.padded_vocab > tc.vocab_size
    x, y = _batch(jc, seed=2)
    (jl, _), jg = _ref_loss_and_grads(jc, params, x, y, z_loss=1e-4,
                                      loss_chunk=4)
    loss, _, grads = _port_loss_and_grads(model, x, y, z_loss=1e-4,
                                          loss_chunk=4)
    assert _rel(loss, jl) <= LOSS_RTOL
    _grads_close(grads, jg, tc)
    assert float(grads["unembed"][:, tc.vocab_size:].abs().max()) == 0.0


@pytest.mark.parametrize("arch", ["llama3-8b", "granite-20b",
                                  "qwen3-moe-235b-a22b"])
def test_flash_branch_gradients_match_reference(flash_at_16, arch):
    """S = 32 > 16: every attention layer takes each package's flash
    branch (counted); the loss and every gradient as the reference's."""
    jc, tc, params, model = _pair(arch)
    x, y = _batch(jc, s=32, seed=3)
    (jl, _), jg = _ref_loss_and_grads(jc, params, x, y, z_loss=1e-4)
    assert flash_at_16["ref"] > 0
    loss, _, grads = _port_loss_and_grads(model, x, y, z_loss=1e-4)
    assert flash_at_16["port"] == tc.num_layers
    assert _rel(loss, jl) <= LOSS_RTOL
    _grads_close(grads, jg, tc)


# ----------------------------------------------------------------------
# remat and router jitter
# ----------------------------------------------------------------------

def _jittered(arch, jitter=0.5):
    """The port's reduced model with router jitter set (MoE: capacity
    factor 8, so the jitter moves routing without drops)."""
    over = {"router_jitter": jitter}
    if tconfigs.get_reduced_config(arch).num_experts:
        over["moe_capacity_factor"] = 8.0
    return _pair(arch, **over)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-moe-235b-a22b",
                                  "mamba2-1.3b", "recurrentgemma-2b"])
def test_remat_modes_are_bitwise_equal(arch):
    _, tc, _, model = _jittered(arch)
    x, y = _batch(tc, seed=4)
    out = {}
    for remat in tlm.REMAT_MODES:
        gen = torch.Generator().manual_seed(11)
        out[remat] = _port_loss_and_grads(
            model, x, y, generator=gen, remat=remat, z_loss=1e-4,
            lb_coef=_lb(tc), loss_chunk=8)
    l0, m0, g0 = out["none"]
    for remat in ("full", "dots"):
        l1, m1, g1 = out[remat]
        assert torch.equal(l1, l0), remat
        assert all(torch.equal(m1[k], m0[k]) for k in m0), remat
        assert all(torch.equal(g1[k], g0[k]) for k in g0), (remat, [
            k for k in g0 if not torch.equal(g1[k], g0[k])])
    with pytest.raises(ValueError, match="remat"):
        tlm.forward_train(model, x, y, remat="some")


def test_router_jitter_draws_from_the_generator():
    _, tc, _, model = _jittered("qwen3-moe-235b-a22b")
    x, y = _batch(tc, seed=5)
    run = lambda seed: tlm.forward_train(
        model, x, y, generator=None if seed is None
        else torch.Generator().manual_seed(seed), lb_coef=_lb(tc))[0]
    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    assert not torch.equal(run(3), run(None))
    # the step's generator is only read (its seed), never advanced
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    tlm.forward_train(model, x, y, generator=gen)
    assert torch.equal(gen.get_state(), state)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b"])
def test_router_jitter_zero_is_todays_result(arch):
    _, tc, _, model = _pair(arch)
    assert tc.router_jitter == 0.0
    x, y = _batch(tc, seed=6)
    with_gen = tlm.forward_train(model, x, y,
                                 generator=torch.Generator().manual_seed(1))
    without = tlm.forward_train(model, x, y)
    assert torch.equal(with_gen[0], without[0])


def test_prefill_and_decode_never_draw(monkeypatch):
    _, tc, _, model = _jittered("qwen3-moe-235b-a22b")
    _, tc0, _, model0 = _pair("qwen3-moe-235b-a22b",
                              moe_capacity_factor=8.0)
    x, _ = _batch(tc, seed=7)

    def no_draw(*a, **kw):
        raise AssertionError("serving drew router jitter")
    monkeypatch.setattr(tmoe.torch, "randn", no_draw)
    sv = ServeConfig(cache_dtype="float32")
    logits, caches = tlm.prefill(model, x[:, :12], sv)
    want, caches0 = tlm.prefill(model0, x[:, :12], sv)
    assert torch.equal(logits, want)
    caches = tlm.pad_caches(caches, tc, 13)
    caches0 = tlm.pad_caches(caches0, tc0, 13)
    got, _ = tlm.decode_step(model, caches, x[:, 12:13], 12, sv)
    want, _ = tlm.decode_step(model0, caches0, x[:, 12:13], 12, sv)
    assert torch.equal(got, want)


def test_layer_keys_fold_as_the_reference():
    cfg = tconfigs.get_config("recurrentgemma-2b")
    pattern, nblocks, tail = cfg.scan_pattern()
    keys = tlm._layer_keys(cfg)
    assert len(keys) == cfg.num_layers == len(set(keys))
    assert keys[:4] == [0, 1, 2, 131]
    assert keys[-2:] == [7919, 7920]


# ----------------------------------------------------------------------
# make_train_step
# ----------------------------------------------------------------------

def _step_close(new, jnew, cfg, ttc):
    """A train step's new parameters and moments against the reference's
    ``jnew``. The moments are (1 - b1) g and (1 - b2) g^2 of the clipped
    gradient g, so they hold the gradient tolerance carried through
    those: |dm| <= (1 - b1) t and |dv| <= (1 - b2) (2 |g| + t) t, with t =
    GRAD_TOL * max(1, max |g|). Adam's first step moves a parameter by lr
    (g / (|g| + eps) + wd p), so it is the reference's within 1e-6
    relative wherever the two first moments agree in sign and |g| > 1e-6
    (100 eps: g / (|g| + eps) is +-1 to 1e-2 of g's relative error), and
    within 2 lr where a gradient within its tolerance of 0 flips sign."""
    b1, b2 = ttc.beta1, ttc.beta2
    lr = float(ttc.learning_rate if ttc.warmup_steps <= 1
               else ttc.learning_rate / ttc.warmup_steps)
    params = dict(new.model.named_parameters())
    want_p = lm_arrays(_np(jnew.params), cfg)
    want_m = lm_arrays(_np(jnew.opt.m), cfg)
    want_v = lm_arrays(_np(jnew.opt.v), cfg)
    assert set(params) == set(want_p) == set(want_m)
    for name, p in params.items():
        g = np.asarray(want_m[name], np.float64) / (1 - b1)
        t = GRAD_TOL * max(1.0, float(np.abs(g).max()))
        dm = np.abs(new.opt.m[name].double().numpy() - want_m[name])
        assert dm.max() <= (1 - b1) * t, (name, "m", dm.max())
        dv = np.abs(new.opt.v[name].double().numpy() - want_v[name])
        assert (dv <= (1 - b2) * (2 * np.abs(g) + t) * t).all(), \
            (name, "v", dv.max())
        want = np.asarray(want_p[name], np.float64)
        dp = np.abs(p.detach().double().numpy() - want)
        exact = 1e-6 * max(1.0, float(np.abs(want).max()))
        same = (np.sign(new.opt.m[name].double().numpy()) == np.sign(g)) \
            & (np.abs(g) > 1e-6)
        assert (same | (np.abs(g) <= t)).all(), (name, "sign")
        bound = np.where(same, exact, 2 * lr + exact)
        assert (dp <= bound).all(), (name, "param", float(dp.max()))


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-moe-235b-a22b",
                                  "mamba2-1.3b", "recurrentgemma-2b"])
def test_train_step_matches_reference(arch, m):
    """One step from the reference's initial state: the metrics within
    1e-5 relative, and the new parameters and moments (``_step_close``).
    lr 1e-2 from step 1 (warm-up 1), so a weight decay that the reference
    applies and the port skips (or the reverse) moves a parameter by
    1e-3 |p|, over the tolerance."""
    jc = jconfigs.get_reduced_config(arch)
    tc = tconfigs.get_reduced_config(arch)
    kw = dict(microbatches=m, remat="full", z_loss=1e-4, loss_chunk=8,
              learning_rate=1e-2, warmup_steps=1)
    jtc, ttc = JTrainConfig(**kw), TrainConfig(**kw)
    jstate = jsteps.init_train_state(jax.random.PRNGKey(0), jc, jtc)
    state = train_state_from_numpy(_np(jstate), tc, ttc, device="cpu")
    x, y = _batch(jc, b=4, seed=8)
    jnew, jmet = jax.jit(jsteps.make_train_step(jc, jtc, None))(
        jstate, {"inputs": jnp.asarray(x), "targets": jnp.asarray(y)},
        jax.random.PRNGKey(2))
    new, met = tsteps.make_train_step(tc, ttc)(
        state, {"inputs": x, "targets": y}, torch.Generator().manual_seed(2))
    assert set(met) == set(jmet)
    assert (m == 1) == ("load_balance" in met)
    for k in ("loss", "ce_loss", "grad_norm"):
        assert _rel(met[k], jmet[k]) <= LOSS_RTOL, k
    assert new.step == int(jnew.step) == 1
    assert new.opt.step == int(jnew.opt.step) == 1
    assert new.model is state.model             # updated in place
    _step_close(new, jnew, tc, ttc)


def test_train_step_refuses_what_is_a13c():
    """The step takes a torch DeviceMesh or None (anything else is a
    ValueError; the mesh step is tests/test_torch_mesh_train.py); zero3
    without a mesh is the single-device step, as the reference's
    make_parallel_ctx has it; a batch the microbatches do not divide is
    refused."""
    tc = tconfigs.get_reduced_config("internlm2-1.8b")
    with pytest.raises(ValueError, match="DeviceMesh"):
        tsteps.make_train_step(tc, TrainConfig(), mesh=object())
    zero3 = tsteps.make_train_step(tc, TrainConfig(sharding_mode="zero3"))
    assert zero3.ctx.mesh is None and zero3.ctx.tp_axis == "model"
    step = tsteps.make_train_step(tc, TrainConfig(microbatches=3))
    state = tsteps.init_train_state(tc, TrainConfig(),
                                    generator=torch.Generator(),
                                    device="cpu")
    x, y = _batch(tc, b=4)
    with pytest.raises(ValueError, match="microbatches"):
        step(state, {"inputs": x, "targets": y})


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode "
                    "(python -m pytest -m gpu tests/test_torch_lm_train.py)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One reduced internlm2 step (float32, remat full, chunked loss) from
    the same reference state on the card and on the CPU: loss and
    grad_norm within 1e-4 relative, every parameter within 1e-3 of its
    max after the update."""
    jc = jconfigs.get_reduced_config("internlm2-1.8b")
    tc = tconfigs.get_reduced_config("internlm2-1.8b")
    ttc = TrainConfig(loss_chunk=8)
    jstate = _np(jsteps.init_train_state(jax.random.PRNGKey(0), jc,
                                         JTrainConfig()))
    x, y = _batch(jc, b=2, seed=9)
    out = {}
    for dev in ("cpu", cuda):
        state = train_state_from_numpy(jstate, tc, ttc, device=dev)
        new, met = tsteps.make_train_step(tc, ttc)(
            state, {"inputs": x, "targets": y})
        out[str(dev)] = ({k: float(v) for k, v in met.items()},
                         {k: p.detach().cpu() for k, p in
                          new.model.named_parameters()})
    (mc, pc), (mg, pg) = out["cpu"], out[str(cuda)]
    for k in ("loss", "grad_norm"):
        assert abs(mg[k] / mc[k] - 1) <= 1e-4, k
    for name, p in pc.items():
        scale = float(p.abs().max())
        assert float((pg[name] - p).abs().max()) <= 1e-3 * scale, name


@pytest.mark.gpu
def test_flash_branch_gradients_on_the_card(cuda):
    """internlm2's reduced config at S = 4,096 in bf16 (heads 4/2 of 32:
    the kernel's D = 32 route): two layers launch the kernel in the
    forward and the backward kernel in the backward; gradients within
    5e-2 of their max against the same model's plain route
    (FLASH_THRESHOLD above S)."""
    from repro_torch.kernels import flash_attention as tflash
    tc = tconfigs.get_reduced_config("internlm2-1.8b",
                                     compute_dtype="bfloat16")
    model = tlm.init_params(tc, generator=torch.Generator(cuda).manual_seed(0),
                            device=cuda).requires_grad_(True)
    x, y = (torch.from_numpy(a).to(cuda) for a in _batch(tc, b=1, s=4096))
    named = dict(model.named_parameters())

    def grads():
        loss, _ = tlm.forward_train(model, x, y, loss_chunk=1024)
        return loss, torch.autograd.grad(loss, list(named.values()))
    n0, b0 = tflash.launches, tflash.backward_calls
    k0 = tflash.backward_launches
    loss, got = grads()
    torch.cuda.synchronize()
    assert tflash.launches - n0 == tflash.backward_calls - b0 == 2
    assert tflash.backward_launches - k0 == 2
    threshold = tlm.FLASH_THRESHOLD
    tlm.FLASH_THRESHOLD = 1 << 20
    try:
        want_loss, want = grads()
    finally:
        tlm.FLASH_THRESHOLD = threshold
    assert abs(float(loss.detach()) / float(want_loss.detach()) - 1) <= 5e-3
    for name, g, w in zip(named, got, want):
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= 5e-2 * scale, \
            name
