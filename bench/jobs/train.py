"""Training steps: the port's ``Trainer`` (``Trainer.run`` ->
``launch/steps.make_train_step``), as a user trains: one ``run`` call of
many steps.

Set-up builds the one training state the window uses: the LM handed the
seeded weights, AdamW's zero moments, and a ``Trainer`` fed token ids
drawn from (seed, step). Its first ``check_steps`` steps run through the
window's own call (``Trainer.run``) in set-up: one step, after which the
first gradient is read, then the rest in one call, whose time a step
sizes the window. After them the state is read for the check (each
step's loss; each tensor's norm of the first gradient as AdamW got it,
from its first moment after one step; each tensor's norm of its change
from the seeded weights). The window is one ``Trainer.run`` of as many
steps as fill ``--seconds`` at that time a step, on that same state; its
rate is over the steps completed and the time to their end. Once the
window has closed and the state is freed, the reference runs the same
first steps from the same weights and batches.
"""
from __future__ import annotations

import math
import statistics
import time

import numpy as np

from bench import common
from bench.harness import (Context, JobResult, checks, free, peak_bytes,
                           rel_gap, sync, traced_window, worst_leaf_gap)

MODEL_KEYS = ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "head_dim", "d_ff", "mlp_activation",
              "mlp_gated", "vocab_size", "rope_theta", "norm_eps",
              "tie_embeddings", "param_dtype", "compute_dtype")
# a tensor whose first gradient in the reference is under this share of
# the median tensor's moves under AdamW by rounding alone: its change is
# not compared
NOUGHT_GRAD = 1e-3


class Tokens:
    """The traffic's token ids: for step s, [batch, seq_len + 1] ids
    uniform over the vocabulary from (seed, s); inputs are the first
    seq_len of each row, targets the last."""

    def __init__(self, seed: int, batch: int, seq_len: int, vocab: int):
        self.key = common.derive_seed(seed, common.INPUTS_KEY)
        self.shape = (batch, seq_len + 1)
        self.vocab = vocab

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng([self.key, step])
        t = rng.integers(0, self.vocab, self.shape, dtype=np.int64)
        t = t.astype(np.int32)
        return {"inputs": np.ascontiguousarray(t[:, :-1]),
                "targets": np.ascontiguousarray(t[:, 1:])}


def run(ctx: Context) -> JobResult:
    import torch
    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.core.convert import lm_stacks
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.train.trainer import Trainer

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    mc = ModelConfig(**{k: cfg[k] for k in MODEL_KEYS})
    tc = TrainConfig(**cfg["train"])
    b, s = tr["batch"], tr["seq_len"]
    dc = DataConfig(seq_len=s, global_batch=b, vocab_size=cfg["vocab_size"])
    source = Tokens(ctx.seed, b, s, cfg["vocab_size"])
    trainer = Trainer(mc, tc, dc, source=source, device=dev,
                      step_deadline_s=3600.0)
    trainer.step_fn = ctx.hooks.get("step_fn", lambda f: f)(trainer.step_fn)
    leaves = common.lm_leaves(cfg)
    model = lm.LM(mc, device=dev)
    params = dict(model.named_parameters())
    common.load_weights(params, leaves, ctx.seed, dev)
    steps.trainable_(model)
    params = dict(model.named_parameters())
    opt = steps.make_optimizer(tc, lm_stacks(params, mc)).init(params)
    state = steps.TrainState(model, opt, 0)
    losses = []
    prog = {}

    def steps_(n: int) -> int:
        """``n`` steps in one ``Trainer.run`` (which ends with the card
        synchronised); the steps it completed."""
        nonlocal state
        state, rep = trainer.run(n, state=state, log_every=0)
        losses.extend(rep.losses)
        return rep.steps_run

    if tr["check_steps"] < 2:
        raise ValueError("a training mix needs 2 check steps or more: "
                         "those after the first size the window")
    steps_(1)
    prog["grad_norms"] = {
        n: float(torch.linalg.vector_norm(m / (1 - tc.beta1)))
        for n, m in state.opt.m.items()}
    t = time.perf_counter()
    steps_(tr["check_steps"] - 1)
    step_s = (time.perf_counter() - t) / (tr["check_steps"] - 1)
    with torch.no_grad():
        prog["change_norms"] = ctx.reference.change_norms(
            dict(state.model.named_parameters()), leaves, ctx.seed, dev)
    prog["losses"] = list(losses)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    losses.clear()
    metrics, reduced = {}, None
    if ctx.trace:
        done = []
        reduced = traced_window(
            lambda: done.append(steps_(tr["trace_units"])), 1)
        units = done[0]
    else:
        start = time.perf_counter()
        units = steps_(window_steps(ctx.seconds, step_s))
        metrics = {"train_tokens_per_s":
                   units * b * s / (time.perf_counter() - start),
                   "setup_s": setup_s}
    failed = int(sum(1 for l in losses if not np.isfinite(l)))
    peak = peak_bytes(dev)
    del state, trainer, model, params, opt
    free(dev)
    found, readings = compare(ctx, leaves, source, prog)
    return JobResult(metrics=metrics, attempted=units, failed=failed,
                     memory_peak_bytes=peak, checks=found,
                     work={"steps": units}, trace=reduced,
                     readings=readings)


def window_steps(seconds: float, step_s: float) -> int:
    """The steps of one ``Trainer.run`` that fill ``seconds`` at
    ``step_s`` a step (one at the least)."""
    return max(1, math.ceil(seconds / step_s))


def reference_run(ctx: Context, leaves, source: Tokens,
                  precision: str = "float32", rows=None) -> dict:
    """The reference's first ``check_steps`` steps on the cell's batches
    (``rows``: a slice of each batch's rows, for a planted fault)."""
    import torch
    batches = []
    for i in range(ctx.traffic["check_steps"]):
        bt = source.batch(i)
        batches.append(tuple(
            torch.from_numpy(bt[k][rows] if rows is not None else bt[k])
            .to(ctx.device) for k in ("inputs", "targets")))
    return ctx.reference.train(ctx.config, ctx.config["train"], leaves,
                               ctx.seed, batches, ctx.device, precision)


def gaps(prog: dict, ref: dict) -> dict:
    """The compared numbers of a program's (or a control's) readings
    against the reference's."""
    med = statistics.median(ref["grad_norms"].values())
    moved = [n for n, g in ref["grad_norms"].items()
             if g >= NOUGHT_GRAD * med]
    return {"loss_gap": max(rel_gap(p, r) for p, r in
                            zip(prog["losses"], ref["losses"])),
            "grad_gap": worst_leaf_gap(prog["grad_norms"],
                                       ref["grad_norms"]),
            "change_gap": worst_leaf_gap(prog["change_norms"],
                                         ref["change_norms"], moved)}


def compare(ctx: Context, leaves, source: Tokens, prog: dict):
    """The numbers the mix gives a limit, as checks; every gap, compared
    or not, among the readings."""
    ref = reference_run(ctx, leaves, source)
    g = gaps(prog, ref)
    g = {k: (v if np.isfinite(v) else float("inf")) for k, v in g.items()}
    return (checks(ctx.traffic, g),
            {"gaps": g, "program_losses": prog["losses"],
             "reference_losses": ref["losses"],
             "reference_grad_global_norm": ref["grad_global_norm"]})


def controls(ctx: Context) -> dict:
    """Readings of what the check has to fail, at the cell's size: the
    reference in the program's place with its products in fp8 (the
    precision below the configuration's bf16), and, where the batch has
    two rows or more, the reference on the first half of each batch's
    rows (half of the batch left out, the mean over the rest)."""
    leaves = common.lm_leaves(ctx.config)
    tr = ctx.traffic
    source = Tokens(ctx.seed, tr["batch"], tr["seq_len"],
                    ctx.config["vocab_size"])
    ref = reference_run(ctx, leaves, source)
    out = {"fp8": gaps(reference_run(ctx, leaves, source, "fp8"), ref)}
    if tr["batch"] >= 2:
        half = slice(0, tr["batch"] // 2)
        out["half_batch"] = gaps(reference_run(ctx, leaves, source,
                                               rows=half), ref)
    return out
