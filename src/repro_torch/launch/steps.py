"""Train / prefill / decode step factories — counterpart of
``repro.launch.steps``.

The factories close over the static config and return functions of
(state or model, data), as the reference's do for its launchers. The
train step runs eagerly (no ``torch.compile``) and updates the state in
place: the model's parameters and the optimizer's moments are written by
``AdamW.update`` under ``torch.no_grad()``.

``make_parallel_ctx`` is the reference's, branch for branch, on a
``DeviceMesh``. Every step runs on a mesh (one process a mesh device):
the model placed on it (``lm.init_params(..., mesh=)``,
``init_train_state(..., mesh=)``), every rank given the whole batch. The
train step differentiates each rank's loss times ``common.loss_scale``
against its parameters' local shards (``models.common``'s gradient
convention), sums the replicas' parts (``common.sum_replicas``), clips by
the norm over the shards and updates each rank's shards in place; in
``sharding_mode`` "zero3" every weight is sharded over every axis and
gathered whole around its use (no tensor parallelism), in "fsdp_tp"
over `data` with the reference's tensor parallelism over `model`.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.compat import DeviceMesh
from repro_torch.configs.base import ModelConfig, ServeConfig, TrainConfig
from repro_torch.core.convert import lm_stacks
from repro_torch.models import lm
from repro_torch.models.common import (ParallelCtx, local, loss_scale,
                                       sum_replicas, torch_dtype)
from repro_torch.train.optimizer import (AdamW, AdamWState,
                                         clip_by_global_norm,
                                         cosine_schedule)


def make_parallel_ctx(mesh, tc: Optional[TrainConfig] = None,
                      sv: Optional[ServeConfig] = None,
                      cfg: Optional[ModelConfig] = None) -> ParallelCtx:
    """The reference's context for ``mesh`` (a DeviceMesh or None):
    ZeRO-3 (every axis data-parallel) for a zero3 train config on a mesh,
    else tensor parallelism over `model`, context parallelism for
    ``sv.seq_parallel`` on a dense, vlm or audio family."""
    if tc is not None and tc.sharding_mode == "zero3" and mesh is not None:
        # ZeRO-3: every mesh axis is data-parallel, no tensor parallelism
        return ParallelCtx(
            mesh=mesh,
            dp_axes=tuple(mesh.mesh_dim_names),
            tp_axis=None,
            sequence_parallel=False,
        )
    seq_shard = bool(sv and sv.seq_parallel and cfg is not None
                     and cfg.family in ("dense", "vlm", "audio"))
    return ParallelCtx(
        mesh=mesh,
        dp_axes=tuple(a for a in (mesh.mesh_dim_names if mesh else ())
                      if a in ("pod", "data")) or ("data",),
        tp_axis="model",
        sequence_parallel=bool(tc and tc.sequence_parallel),
        decode_seq_parallel=(sv.decode_seq_parallel if sv else True),
        seq_shard_acts=seq_shard,
    )


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


def check_mesh(mesh) -> None:
    """A step's ``mesh`` is a torch ``DeviceMesh`` (``launch.mesh``) or
    None; anything else raises ValueError."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise ValueError(f"mesh: a torch DeviceMesh (launch.mesh.mesh_of) "
                         f"or None, not {type(mesh).__name__}")


def trainable_(model: lm.LM) -> lm.LM:
    """The model's parameters made what the train step differentiates
    against: each parameter, or on a mesh each DTensor parameter's local
    shard (``common.local``), requires grad."""
    for p in model.parameters():
        local(p).requires_grad_(True)
    return model


def init_train_state(cfg: ModelConfig, tc: TrainConfig, *,
                     generator: torch.Generator, device=None,
                     mesh=None) -> TrainState:
    """A fresh state: ``lm.init_params`` drawn from ``generator`` (on its
    own device), zero moments in ``tc.opt_state_dtype``, step 0.
    ``device=None`` means CUDA. ``mesh``: the parameters are this rank's
    shards as ``sharding.params_shardings(model, cfg, mesh,
    tc.sharding_mode)`` places them, the moments placed as their
    parameters (the same numbers as without a mesh)."""
    check_mesh(mesh)
    mode = tc.sharding_mode if mesh is not None else "fsdp_tp"
    model = trainable_(lm.init_params(cfg, generator=generator,
                                      device=device, mesh=mesh, mode=mode))
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
    ``ce_loss``), 0-d tensors on the model's device (no host sync).

    ``mesh`` (a DeviceMesh; the state placed on it by
    ``init_train_state(..., mesh=)``): every rank passes the whole batch,
    each microbatch's rows are split over the batch axes of
    ``tc.sharding_mode`` (``sharding.batch_shardings``), the metrics are
    the global batch's on every rank, and each rank's shards are updated.
    ``train_step.ctx`` is the step's ParallelCtx (its ``comm`` counts the
    collectives, the backward's apart); ``train_step.loss_and_grads(state,
    batch, generator)`` -> (metrics, {name: gradient}) runs the step's
    forward and backward alone: the accumulated gradients (local shards on
    a mesh, their replicas summed) before clipping."""
    check_mesh(mesh)
    ctx = make_parallel_ctx(mesh, tc=tc, cfg=cfg)
    opt = None          # made at the first step: its stacks are the model's
    M = max(tc.microbatches, 1)
    acc_dt = torch_dtype(tc.grad_acc_dtype)
    scale = loss_scale(ctx)

    def micro_grads(model, params, inputs, targets, generator):
        loss, metrics = lm.forward_train(
            model, inputs, targets, generator=generator, remat=tc.remat,
            loss_chunk=tc.loss_chunk, z_loss=tc.z_loss,
            lb_coef=cfg.load_balance_coef if cfg.num_experts else 0.0,
            ctx=ctx)
        grads = torch.autograd.grad(
            loss * scale, [local(p) for p in params.values()],
            allow_unused=True, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(params, grads))

    def loss_and_grads(state: TrainState, batch: Dict, generator:
                       Optional[torch.Generator] = None):
        model = state.model
        if model.cfg != cfg:
            raise ValueError("the model was built for another config")
        params = dict(model.named_parameters())
        inputs, targets = batch["inputs"], batch["targets"]
        b = inputs.shape[0]
        if b % M:
            raise ValueError(f"batch {b} does not split into {M} "
                             f"microbatches")
        if M == 1:
            _, metrics, grads = micro_grads(model, params, inputs, targets,
                                            generator)
        else:
            seed = None if generator is None else generator.initial_seed()
            bm = b // M
            grads = {k: torch.zeros(local(p).shape, dtype=acc_dt,
                                    device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for m in range(M):
                gm = None if seed is None else derive_generator(seed, m)
                sl = slice(m * bm, (m + 1) * bm)
                lm_, _, g = micro_grads(model, params, inputs[sl],
                                        targets[sl], gm)
                for k, a in grads.items():
                    a.add_(g[k].to(acc_dt) / M)
                del g
                loss = loss + lm_ / M
            metrics = {"ce_loss": loss}
        if mesh is not None:
            sum_replicas(grads, params, ctx.comm)
        return metrics, grads

    def train_step(state: TrainState, batch: Dict, generator:
                   Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        nonlocal opt
        metrics, grads = loss_and_grads(state, batch, generator)
        params = dict(state.model.named_parameters())
        if opt is None:
            opt = make_optimizer(tc, lm_stacks(params, cfg))
        like = params if mesh is not None else None
        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip, like,
                                           ctx.comm)
        _, opt_state = opt.update(grads, state.opt, params)
        del grads
        metrics["grad_norm"] = gnorm
        metrics["loss"] = metrics["ce_loss"]
        return TrainState(state.model, opt_state, state.step + 1), metrics

    train_step.ctx = ctx
    train_step.loss_and_grads = loss_and_grads
    return train_step


# ----------------------------------------------------------------------
# serve
# ----------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, sv: ServeConfig,
                      mesh=None) -> Callable:
    """prefill_step(model, inputs) -> (last logits, caches). On a mesh
    the model is placed on it and every rank passes the whole batch;
    ``prefill_step.ctx`` is the step's ParallelCtx (its ``comm`` counts
    the collectives)."""
    ctx = make_parallel_ctx(mesh, sv=sv, cfg=cfg)

    def prefill_step(model, inputs):
        if model.cfg != cfg:
            raise ValueError("the model was built for another config")
        return lm.prefill(model, inputs, sv, ctx)
    prefill_step.ctx = ctx
    return prefill_step


def make_decode_step(cfg: ModelConfig, sv: ServeConfig,
                     mesh=None) -> Callable:
    """decode_step(model, caches, token, pos) -> (logits, caches); on a
    mesh as ``make_prefill_step``."""
    ctx = make_parallel_ctx(mesh, sv=sv, cfg=cfg)

    def decode_step(model, caches, token, pos):
        if model.cfg != cfg:
            raise ValueError("the model was built for another config")
        return lm.decode_step(model, caches, token, pos, sv, ctx)
    decode_step.ctx = ctx
    return decode_step
