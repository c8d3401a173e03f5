"""The plain references against the port at a tiny size on the CPU,
where the port runs its plain versions: the same seeded weights and
inputs give the same features, loss, gradients and steps."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench import common
from bench.reference import dense_lm, precision, vit

from conftest import tiny_ctx


def test_vit_reference_equals_the_port():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.features.vit import ViT, extract_features
    from bench.jobs.embed import MODEL_KEYS
    _, parts, ctx = tiny_ctx("vit_t.embed_400")
    cfg = ctx.config
    leaves = common.vit_leaves(cfg)
    model = ViT(ModelConfig(**{k: cfg[k] for k in MODEL_KEYS}),
                image_size=cfg["image_size"], patch_size=cfg["patch_size"],
                device="cpu")
    common.load_weights(dict(model.named_parameters()), leaves, 5, "cpu")
    x = torch.rand((3, cfg["image_size"], cfg["image_size"], 3),
                   generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = extract_features(model, x)
    want = vit.features(common.weights(leaves, 5, "cpu"), x, cfg)
    assert got.shape == (3, 2 * cfg["d_model"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _port_lm(cfg, seed):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import lm
    from bench.jobs.train import MODEL_KEYS
    model = lm.LM(ModelConfig(**{k: cfg[k] for k in MODEL_KEYS}),
                  device="cpu")
    params = dict(model.named_parameters())
    common.load_weights(params, common.lm_leaves(cfg), seed, "cpu")
    return model


def test_lm_reference_loss_and_gradients_equal_the_port():
    from repro_torch.models import lm
    _, parts, ctx = tiny_ctx("internlm2.train_4k")
    cfg, tc = ctx.config, ctx.config["train"]
    model = _port_lm(cfg, 9)
    for p in model.parameters():
        p.requires_grad_(True)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg["vocab_size"], (2, 65)))
    inp, tgt = toks[:, :-1], toks[:, 1:]
    loss, _ = lm.forward_train(model, inp, tgt, remat="full",
                               loss_chunk=tc["loss_chunk"],
                               z_loss=tc["z_loss"])
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    w = {n: t.requires_grad_(True) for n, t in
         common.weights(common.lm_leaves(cfg), 9, "cpu").items()}
    ref = dense_lm.loss(w, inp, tgt, cfg, tc["z_loss"])
    ref_grads = torch.autograd.grad(ref, [w[n] for n in names])
    torch.testing.assert_close(loss, ref, rtol=1e-5, atol=1e-6)
    for n, g, r in zip(names, grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-6, msg=n)


def test_reference_steps_follow_the_ports_optimizer():
    """The reference's three steps and the job's readings of the port's
    three steps agree to float32 rounding."""
    from bench.jobs import train
    _, parts, ctx = tiny_ctx("internlm2.train_4k")
    res = parts["job"].run(ctx)
    gaps = {c.name: c.value for c in res.checks}
    assert gaps["loss_gap"] < 1e-6
    assert gaps["grad_gap"] < 1e-5
    assert gaps["change_gap"] < 1e-4
    assert res.readings["program_losses"] == pytest.approx(
        res.readings["reference_losses"], rel=1e-6)


@pytest.mark.parametrize("name", precision.PRECISIONS)
def test_precision_rounding(name):
    x = torch.tensor([1.0 + 2 ** -12, -3.0 + 2 ** -9, 0.3], requires_grad=True)
    r = precision.rounder(name)(x)
    err = (r - x).abs().max().item()
    want = {"float32": 0.0, "tf32": 2 ** -10, "fp8": 0.2}[name]
    assert err <= want * 3.0
    if name != "float32":
        assert err > 0
        r.sum().backward()                 # the identity's gradient
        assert torch.equal(x.grad, torch.ones(3))


def test_learning_rate_and_decay_rule():
    tc = {"learning_rate": 3e-4, "warmup_steps": 100, "total_steps": 10000}
    assert dense_lm.learning_rate(tc, 1) == pytest.approx(3e-6)
    assert dense_lm.learning_rate(tc, 10000) == pytest.approx(3e-5)
    assert dense_lm.decays("layers.3.norm1", torch.zeros(4))
    assert not dense_lm.decays("final_norm", torch.zeros(4))
    assert dense_lm.decays("embed", torch.zeros(4, 4))
