"""The training substrate — counterpart of ``repro.train``: optimizers,
checkpoints, gradient compression, failure handling and the Trainer."""
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.compression import (Int8ErrorFeedback, Quantized,
                                           compressed_cross_pod_mean,
                                           compression_ratio)
from repro_torch.train.elastic import (Heartbeat, Preemption, remesh,
                                       reshard_state,
                                       simulate_failure_and_restart)
from repro_torch.train.optimizer import (AdamW, AdamWState, Adafactor,
                                         clip_by_global_norm,
                                         cosine_schedule, global_norm)

__all__ = [
    "AdamW", "AdamWState", "Adafactor", "CheckpointManager", "Heartbeat",
    "Int8ErrorFeedback", "Preemption", "Quantized", "Trainer",
    "TrainerReport", "clip_by_global_norm", "compressed_cross_pod_mean",
    "compression_ratio", "cosine_schedule", "global_norm", "remesh",
    "reshard_state", "simulate_failure_and_restart",
]


def __getattr__(name):
    # Trainer imports launch.steps which imports this package; resolve
    # lazily to keep the import graph acyclic.
    if name in ("Trainer", "TrainerReport"):
        from repro_torch.train import trainer as _t
        return getattr(_t, name)
    raise AttributeError(name)
