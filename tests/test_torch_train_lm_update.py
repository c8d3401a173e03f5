"""The port's optimizers over a reduced LM against the reference's (the
LM half of tests/test_torch_train.py's optimizer twins, a file of its
own for its run time), for four architectures whose block-stacked
leaves differ: internlm2 and qwen3 (norms, an MoE router), mamba2 (SSD's
A_log / D / dt_bias) and recurrentgemma (RG-LRU's lam, a tail layer).

Both packages start from the reference's initial TrainState (crossed by
``train_state_from_numpy``) and are fed, for three steps, the
reference's gradients at its own current parameters, so a last-bit
difference in a tiny gradient cannot become Adam's 2 lr. AdamW (after
each package's clip, the norms and clipped gradients compared) and
Adafactor: every new parameter, moment and factored statistic within
1e-6 relative of each tensor's max |value|. The reference applies its
per-leaf rules (decay and factoring by rank, Adafactor's RMS clip) to
the leaves stacked over blocks; the port reads the same leaves through
``core.convert.lm_stacks``. On the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.configs.base import TrainConfig
from repro_torch.core.convert import (_layer_slots, lm_arrays, lm_stacks,
                                      train_state_from_numpy)
from repro_torch.launch import steps as tsteps
from repro_torch.train import optimizer as topt
from test_torch_train import CTX, _close, _np

LM_UPDATE_ARCHS = ["internlm2-1.8b", "qwen3-moe-235b-a22b", "mamba2-1.3b",
                   "recurrentgemma-2b"]
# lr 1e-2 from step 1: a weight decay wrongly applied or skipped moves a
# parameter by lr * 0.1 * |p|, far over the 1e-6 relative tolerance.
LM_UPDATE_TC = dict(learning_rate=1e-2, warmup_steps=1)


def _lm_update_setup(arch):
    """(reference cfg, port cfg, reference TrainState, the port's, a
    function params -> the reference's gradients of one batch)."""
    jc = jconfigs.get_reduced_config(arch)
    tc = tconfigs.get_reduced_config(arch)
    jstate = jsteps.init_train_state(jax.random.PRNGKey(0), jc,
                                     JTrainConfig(**LM_UPDATE_TC))
    state = train_state_from_numpy(_np(jstate), tc,
                                   TrainConfig(**LM_UPDATE_TC), device="cpu")
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.integers(0, jc.vocab_size, (2, 16)), jnp.int32)
    if jc.input_mode == "embeddings":
        x = jnp.asarray(rng.normal(0, 1, (2, 16, jc.d_model)), jnp.float32)
    y = jnp.asarray(rng.integers(0, jc.vocab_size, (2, 16)), jnp.int32)
    grad_fn = jax.jit(jax.grad(lambda p: jlm.forward_train(
        p, x, y, jc, CTX, z_loss=1e-4)[0]))
    return jc, tc, jstate, state, grad_fn


@pytest.mark.parametrize("arch", LM_UPDATE_ARCHS)
def test_lm_update_matches_reference_on_its_gradients(arch):
    """A reduced LM's TrainState and, for three steps, the reference's
    gradients at its own current parameters: each package's clip of them
    (the norm and the clipped gradients), then an AdamW update of the
    reference's clipped gradients; every new parameter and moment within
    1e-6 relative. The reference decays every stacked block leaf (its
    norms, SSD's A_log / D / dt_bias, RG-LRU's lam: 2-d there); the
    port's stacks make it do so too. (The two norms sum in other orders,
    4e-7 apart here: fed on, that would move the second moments by
    1e-6.)"""
    jc, tc, jstate, state, grad_fn = _lm_update_setup(arch)
    jp, jos = jstate.params, jstate.opt
    jopt_ = jsteps.make_optimizer(JTrainConfig(**LM_UPDATE_TC))
    params = dict(state.model.named_parameters())
    opt = tsteps.make_optimizer(TrainConfig(**LM_UPDATE_TC),
                                lm_stacks(params, tc))
    opt_state = state.opt
    for _ in range(3):
        jgrads = grad_fn(jp)
        jg, jnorm = jopt.clip_by_global_norm(jgrads, 0.5)
        jp, jos = jopt_.update(jg, jos, jp)
        grads = {k: torch.tensor(v) for k, v in
                 lm_arrays(_np(jgrads), tc).items()}
        grads, norm = topt.clip_by_global_norm(grads, 0.5)
        _close(norm, jnorm)
        clipped = lm_arrays(_np(jg), tc)
        for name, g in grads.items():
            _close(g, clipped[name])
        grads = {k: torch.tensor(v) for k, v in clipped.items()}
        _, opt_state = opt.update(grads, opt_state, params)
        for name, want in lm_arrays(_np(jp), tc).items():
            _close(params[name], want)
        for which in ("m", "v"):
            want = lm_arrays(_np(getattr(jos, which)), tc)
            for name, t in getattr(opt_state, which).items():
                _close(t, want[name])
    assert opt_state.step == int(jos.step) == 3


def _factored_by_leaf(factored, cfg) -> dict:
    """The reference's Adafactor statistics tree as {the port's leaf
    name: {"vr", "vc"} or {"v"}}: ``blocks.slotN.<path>`` as it is, a
    tail layer's leaves under the port's layer name."""
    out = {}

    def walk(d, prefix):
        if "v" in d or "vr" in d:
            out[prefix] = {k: np.asarray(v) for k, v in d.items()}
            return
        for k, v in d.items():
            if v is not None:
                walk(v, f"{prefix}.{k}" if prefix else k)
    walk(factored, "")
    tail = {f"tail.{key}.": f"layers.{i}." for i, (part, key, _)
            in _layer_slots(cfg) if part == "tail"}
    for old, new in tail.items():
        for k in [k for k in out if k.startswith(old)]:
            out[new + k[len(old):]] = out.pop(k)
    return out


@pytest.mark.parametrize("arch", LM_UPDATE_ARCHS)
def test_lm_adafactor_matches_reference_on_its_gradients(arch):
    """Adafactor over a reduced LM, three steps of the reference's
    gradients: the port factors each stacked block leaf as the reference
    (a stacked norm [nblocks, d] gets vr [nblocks] and vc [d]) and clips
    its update's RMS over the whole stack; every new parameter and
    statistic within 1e-6 relative."""
    jc, tc, jstate, state, grad_fn = _lm_update_setup(arch)
    jp = jstate.params
    jo = jopt.Adafactor(lambda s: 0.05)
    params = dict(state.model.named_parameters())
    to = topt.Adafactor(lambda s: 0.05, stacks=lm_stacks(params, tc))
    js, ts = jo.init(jp), to.init(params)
    for _ in range(3):
        jg = grad_fn(jp)
        jp, js = jo.update(jg, js, jp)
        grads = {k: torch.tensor(v) for k, v in
                 lm_arrays(_np(jg), tc).items()}
        _, ts = to.update(grads, ts, params)
        for name, want in lm_arrays(_np(jp), tc).items():
            _close(params[name], want)
        want = _factored_by_leaf(js["factored"], tc)
        assert set(ts["factored"]) == set(want)
        for k, stats in ts["factored"].items():
            assert set(stats) == set(want[k]), k
            for n, v in stats.items():
                _close(v, want[k][n])
    assert ts["step"] == int(js["step"]) == 3
