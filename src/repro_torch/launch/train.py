"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` — counterpart of ``repro.launch.train``.

Drives the Trainer with the real (full-size) config or the reduced one
(--reduced, the CPU-friendly path), on CUDA unless ``--device cpu`` is
given. Under a world of several processes (``torchrun``: ``WORLD_SIZE``
in the environment) each rank joins the group with ``--backend`` (gloo
by default: several ranks on one card; nccl for one card a rank) and
the Trainer runs on ``make_host_mesh()``, a (data, 1) mesh over the
world, as the reference's launcher; with one process
``make_host_mesh`` gives None and it runs on one device. Checkpoints and
restarts work as the reference's; the printed line is the reference's
(rank 0's on a world).
"""
from __future__ import annotations

import argparse
import logging
import os

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import init_process_group, make_host_mesh
from repro_torch.train.trainer import Trainer


def join_world(backend: str, device: str) -> str:
    """Join the world ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) where it has more
    than one rank; returns the device this rank trains on (a CUDA rank
    takes card ``LOCAL_RANK`` modulo the cards there are)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return device
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = f"cuda:{local % torch.cuda.device_count()}"
    init_process_group(backend, rank=int(os.environ["RANK"]),
                       world_size=world, init_method="env://",
                       device=device)
    return device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "full", "dots"])
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the device to train on (cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="the process group's backend under a world")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    tc = TrainConfig(learning_rate=args.lr, microbatches=args.microbatches,
                     remat=args.remat,
                     warmup_steps=min(20, args.steps // 5 + 1),
                     total_steps=args.steps, seed=args.seed,
                     z_loss=0.0, loss_chunk=0)
    dc = DataConfig(seq_len=args.seq_len, global_batch=args.batch,
                    vocab_size=cfg.vocab_size, seed=args.seed)

    device = join_world(args.backend, args.device)
    mesh = make_host_mesh(device_type=torch.device(device).type)

    trainer = Trainer(cfg, tc, dc, mesh=mesh,
                      checkpoint_dir=args.checkpoint_dir,
                      checkpoint_every=args.checkpoint_every,
                      device=device)
    state, report = trainer.run(args.steps, log_every=args.log_every)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dist.is_initialized():
        dist.destroy_process_group()
    if rank != 0:
        return 0
    print(f"arch={cfg.name} steps={report.steps_run} "
          f"loss[first]={report.losses[0]:.4f} "
          f"loss[last]={report.final_loss:.4f} "
          f"tokens/s={report.tokens_per_s:,.0f} "
          f"resumed_from={report.resumed_from} "
          f"preempted={report.preempted}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
