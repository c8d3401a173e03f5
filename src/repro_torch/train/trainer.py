"""The training loop — checkpointed, preemptible, straggler-aware;
counterpart of ``repro.train.trainer``.

Composes the substrate:
  steps.make_train_step  (eager, microbatched, remat)
  data.Prefetcher        (deterministic resumable batches)
  checkpoint.CheckpointManager (atomic, async)
  elastic.{Preemption, Heartbeat}

One device (CUDA unless ``device="cpu"``), or a mesh (``mesh=``, a
DeviceMesh; one process a mesh device, each on ``device``): the state is
placed on it by the rules of ``tc.sharding_mode``
(``init_train_state(..., mesh=)``), every rank is fed the global batch,
which the step splits over the batch axes, checkpoints are saved by the
mesh's first rank and restored onto any mesh, and ``tokens_per_s``
counts the global batch's tokens. Every rank of the mesh runs the same
loop; a preemption on any rank stops them all at the same step.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import DataConfig, Prefetcher, TokenSource
from repro_torch.device import resolve_device, to_device_async
from repro_torch.launch.steps import (TrainState, derive_generator,
                                      init_train_state, make_train_step)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import Heartbeat, Preemption

log = logging.getLogger("repro_torch.trainer")


@dataclass
class TrainerReport:
    steps_run: int = 0
    final_loss: float = float("nan")
    losses: List[float] = field(default_factory=list)
    straggler_events: int = 0
    preempted: bool = False
    resumed_from: Optional[int] = None
    tokens_per_s: float = 0.0


class Trainer:
    """The reference's Trainer, on one device or a mesh. Step ``s`` runs
    with the generator ``derive_generator(tc.seed ^ 0x5EED, s)`` (the
    reference folds ``s`` into ``PRNGKey(tc.seed ^ 0x5EED)``)."""

    def __init__(
        self,
        cfg: ModelConfig,
        tc: TrainConfig,
        dc: DataConfig,
        *,
        mesh=None,
        checkpoint_dir: Optional[str | Path] = None,
        checkpoint_every: int = 50,
        step_deadline_s: float = 300.0,
        source=None,
        device=None,
    ):
        self.cfg, self.tc, self.dc = cfg, tc, dc
        self.mesh = mesh
        self.device = resolve_device(device)
        self.step_fn = make_train_step(cfg, tc, mesh)
        self.source = source or TokenSource(dc)
        self.ckpt = (CheckpointManager(checkpoint_dir, mesh=mesh)
                     if checkpoint_dir else None)
        self.checkpoint_every = checkpoint_every
        self.step_deadline_s = step_deadline_s
        self._resumed_from: Optional[int] = None

    # ------------------------------------------------------------------
    def init_or_restore(self, seed: int = 0) -> TrainState:
        """A fresh state drawn from a generator seeded ``seed`` on the
        trainer's device (placed on the mesh, where there is one), then
        the latest checkpoint loaded into it where one exists (on a mesh,
        each rank its shards: a checkpoint of any mesh or of one
        device)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        state = init_train_state(self.cfg, self.tc, generator=gen,
                                 device=self.device, mesh=self.mesh)
        self._resumed_from = None
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            state = self.ckpt.restore(state)
            self._resumed_from = int(state.step)
            log.info("restored checkpoint at step %s", self._resumed_from)
        return state

    # ------------------------------------------------------------------
    def run(self, num_steps: int, *, state: Optional[TrainState] = None,
            log_every: int = 10) -> tuple[TrainState, TrainerReport]:
        """``num_steps`` steps from ``state`` (default: init_or_restore of
        ``tc.seed``); ``tokens_per_s`` by the host clock, the card
        synchronised at the end."""
        report = TrainerReport()
        if state is None:
            state = self.init_or_restore(self.tc.seed)
        report.resumed_from = self._resumed_from
        start_step = int(state.step)
        prefetch = Prefetcher(self.source, start_step=start_step)
        preempt = Preemption()
        hb = Heartbeat(self.step_deadline_s,
                       lambda dt: self._on_straggler(report, dt))
        seed = self.tc.seed ^ 0x5EED

        tokens = self.dc.global_batch * self.dc.seq_len
        t0 = time.perf_counter()
        try:
            for step in range(start_step, start_step + num_steps):
                batch = {k: to_device_async(v, self.device)
                         for k, v in next(prefetch).items()}
                state, metrics = self.step_fn(state, batch,
                                              derive_generator(seed, step))
                hb.beat()
                loss = float(metrics["loss"])
                report.losses.append(loss)
                report.steps_run += 1
                if log_every and (step % log_every == 0):
                    log.info("step %d loss %.4f", step, loss)
                if (self.ckpt is not None and self.checkpoint_every
                        and (step + 1) % self.checkpoint_every == 0):
                    self.ckpt.save_async(step + 1, state)
                if self._preempted(preempt):
                    report.preempted = True
                    if self.ckpt is not None:
                        self.ckpt.save(step + 1, state)
                    break
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            prefetch.close()
            hb.close()
            preempt.restore()
            if self.ckpt is not None:
                self.ckpt.wait()
        dt = time.perf_counter() - t0
        report.final_loss = report.losses[-1] if report.losses \
            else float("nan")
        report.tokens_per_s = report.steps_run * tokens / max(dt, 1e-9)
        return state, report

    def _preempted(self, preempt: Preemption) -> bool:
        """The preemption flag; on a mesh, whether any rank has it (so
        every rank saves and stops at the same step)."""
        if self.mesh is None:
            return preempt.requested
        from repro_torch.launch.mesh import any_rank
        return any_rank(preempt.requested, self.mesh)

    def _on_straggler(self, report: TrainerReport, dt: float) -> None:
        report.straggler_events += 1
        log.warning("straggler: step exceeded %.1fs (%.1fs)",
                    self.step_deadline_s, dt)
