"""Train / prefill / decode step factories — counterpart of
``repro.launch.steps``.

The factories close over the static config and return functions of
(state or model, data), as the reference's do for its launchers. The
train step runs eagerly (no ``torch.compile``) and updates the state in
place: the model's parameters and the optimizer's moments are written by
``AdamW.update`` under ``torch.no_grad()``. One device: a ``mesh`` other
than None, and ``sharding_mode="zero3"``, are refused (the sharded LM is
ROADMAP A13c).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ServeConfig, TrainConfig
from repro_torch.core.convert import lm_stacks
from repro_torch.models import lm
from repro_torch.models.common import torch_dtype
from repro_torch.train.optimizer import (AdamW, AdamWState,
                                         clip_by_global_norm,
                                         cosine_schedule)


def _one_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the port's LM runs on one device; a mesh (sharded train, "
            "prefill and decode steps, ParallelCtx's modes) is ROADMAP A13c")


class TrainState(NamedTuple):
    """``model``: the LM, its parameters requiring grad; ``opt``: AdamW's
    moments by parameter name and its step; ``step``: steps taken."""
    model: lm.LM
    opt: AdamWState
    step: int


def make_optimizer(tc: TrainConfig, stacks=None) -> AdamW:
    """``stacks``: the reference's stacked leaves (an LM's:
    ``core.convert.lm_stacks``), whose rank decides weight decay."""
    return AdamW(
        cosine_schedule(tc.learning_rate, tc.warmup_steps, tc.total_steps),
        beta1=tc.beta1, beta2=tc.beta2, weight_decay=tc.weight_decay,
        state_dtype=tc.opt_state_dtype, stacks=stacks)


def init_train_state(cfg: ModelConfig, tc: TrainConfig, *,
                     generator: torch.Generator, device=None) -> TrainState:
    """A fresh state: ``lm.init_params`` drawn from ``generator`` (on its
    own device), zero moments in ``tc.opt_state_dtype``, step 0.
    ``device=None`` means CUDA."""
    model = lm.init_params(cfg, generator=generator, device=device)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt = make_optimizer(tc, lm_stacks(params, cfg)).init(params)
    return TrainState(model, opt, 0)


def derive_generator(seed: int, key: int) -> torch.Generator:
    """A CPU generator seeded from (seed, key) (``lm.derive_seed``): the
    trainer's per-step and the step's per-microbatch generators, standing
    in for the reference's ``fold_in``. Only its seed is read."""
    return torch.Generator().manual_seed(lm.derive_seed(seed, key))


# ----------------------------------------------------------------------
# train
# ----------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    mesh=None) -> Callable:
    """Returns train_step(state, batch, generator) -> (state, metrics).

    Gradient accumulation: the batch is split into ``tc.microbatches``
    chunks of consecutive rows (the reference's reshape) run one after
    another, each microbatch m with the generator ``derive_generator(
    generator.initial_seed(), m)``; float32 (``tc.grad_acc_dtype``)
    accumulators ``acc + g / M`` and the loss ``acc_l + l / M`` from 0.
    Each microbatch's backward is remat'd per ``tc.remat``. Then global-
    norm clipping and AdamW. ``metrics``: ``ce_loss`` and (M = 1 only, as
    the reference) ``load_balance``, then ``grad_norm`` and ``loss`` (=
    ``ce_loss``), 0-d tensors on the model's device (no host sync)."""
    _one_device(mesh)
    if tc.sharding_mode == "zero3":
        raise NotImplementedError(
            "sharding_mode='zero3' shards the state over a mesh; the port "
            "trains on one device (the mesh is ROADMAP A13c)")
    opt = None          # made at the first step: its stacks are the model's
    M = max(tc.microbatches, 1)
    acc_dt = torch_dtype(tc.grad_acc_dtype)

    def loss_and_grads(model, params, inputs, targets, generator):
        loss, metrics = lm.forward_train(
            model, inputs, targets, generator=generator, remat=tc.remat,
            loss_chunk=tc.loss_chunk, z_loss=tc.z_loss,
            lb_coef=cfg.load_balance_coef if cfg.num_experts else 0.0)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(params, grads))

    def train_step(state: TrainState, batch: Dict, generator:
                   Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        nonlocal opt
        model = state.model
        if model.cfg != cfg:
            raise ValueError("the model was built for another config")
        params = dict(model.named_parameters())
        if opt is None:
            opt = make_optimizer(tc, lm_stacks(params, cfg))
        inputs, targets = batch["inputs"], batch["targets"]
        b = inputs.shape[0]
        if b % M:
            raise ValueError(f"batch {b} does not split into {M} "
                             f"microbatches")
        if M == 1:
            _, metrics, grads = loss_and_grads(model, params, inputs,
                                               targets, generator)
        else:
            seed = None if generator is None else generator.initial_seed()
            bm = b // M
            grads = {k: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for m in range(M):
                gm = None if seed is None else derive_generator(seed, m)
                sl = slice(m * bm, (m + 1) * bm)
                lm_, _, g = loss_and_grads(model, params, inputs[sl],
                                           targets[sl], gm)
                for k, a in grads.items():
                    a.add_(g[k].to(acc_dt) / M)
                del g
                loss = loss + lm_ / M
            metrics = {"ce_loss": loss}
        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
        _, opt_state = opt.update(grads, state.opt, params)
        del grads
        metrics["grad_norm"] = gnorm
        metrics["loss"] = metrics["ce_loss"]
        return TrainState(model, opt_state, state.step + 1), metrics

    return train_step


# ----------------------------------------------------------------------
# serve
# ----------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, sv: ServeConfig,
                      mesh=None) -> Callable:
    """prefill_step(model, inputs) -> (last logits, caches)."""
    _one_device(mesh)

    def prefill_step(model, inputs):
        if model.cfg != cfg:
            raise ValueError("the model was built for another config")
        return lm.prefill(model, inputs, sv)
    return prefill_step


def make_decode_step(cfg: ModelConfig, sv: ServeConfig,
                     mesh=None) -> Callable:
    """decode_step(model, caches, token, pos) -> (logits, caches)."""
    _one_device(mesh)

    def decode_step(model, caches, token, pos):
        if model.cfg != cfg:
            raise ValueError("the model was built for another config")
        return lm.decode_step(model, caches, token, pos, sv)
    return decode_step
