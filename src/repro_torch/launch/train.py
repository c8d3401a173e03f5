"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` — counterpart of ``repro.launch.train``.

Drives the Trainer with the real (full-size) config or the reduced one
(--reduced, the CPU-friendly path), on one device: CUDA unless
``--device cpu`` is given (a mesh is ROADMAP A13c). Checkpoints and
restarts work as the reference's; the printed line is the reference's.
"""
from __future__ import annotations

import argparse
import logging

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.trainer import Trainer


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

    trainer = Trainer(cfg, tc, dc, checkpoint_dir=args.checkpoint_dir,
                      checkpoint_every=args.checkpoint_every,
                      device=args.device)
    state, report = trainer.run(args.steps, log_every=args.log_every)
    print(f"arch={cfg.name} steps={report.steps_run} "
          f"loss[first]={report.losses[0]:.4f} "
          f"loss[last]={report.final_loss:.4f} "
          f"tokens/s={report.tokens_per_s:,.0f} "
          f"resumed_from={report.resumed_from} "
          f"preempted={report.preempted}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
