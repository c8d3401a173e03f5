"""Config registry: ``get_config("--arch id")`` plus shape/mesh lookups
(counterpart of ``repro.configs``, the same registry and defaults)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (
    MeshConfig,
    ModelConfig,
    RunConfig,
    ServeConfig,
    ShapeConfig,
    SHAPES,
    SHAPES_BY_NAME,
    TrainConfig,
    reduced,
)

# arch id -> module name
_ARCH_MODULES: Dict[str, str] = {
    "granite-20b": "granite_20b",
    "nemotron-4-15b": "nemotron_4_15b",
    "internlm2-1.8b": "internlm2_1_8b",
    "llama3-8b": "llama3_8b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "musicgen-medium": "musicgen_medium",
    "mamba2-1.3b": "mamba2_1_3b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "rapidearth-vit-t": "rapidearth_vit",
}

ASSIGNED_ARCHS: List[str] = [a for a in _ARCH_MODULES if a != "rapidearth-vit-t"]

# Archs with a sub-quadratic sequence mechanism — the only ones that run
# the long_500k cell (see DESIGN.md §Arch-applicability for the skips).
SUBQUADRATIC_ARCHS = ("mamba2-1.3b", "recurrentgemma-2b")


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_reduced_config(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)


def shape_cells(arch: str) -> List[ShapeConfig]:
    """The live (non-skipped) shape cells for an arch."""
    cfg = get_config(arch)
    cells = []
    for s in SHAPES:
        if s.name == "long_500k" and arch not in SUBQUADRATIC_ARCHS:
            continue  # full-attention arch: 500k dense KV is out of scope (DESIGN.md)
        cells.append(s)
    return cells


def default_train_config(arch: str, shape: ShapeConfig | None = None) -> TrainConfig:
    """Per-arch defaults chosen so train_4k fits 16 GB/chip on the 16x16 mesh.

    Microbatches target <=128k tokens per accumulation chunk: the scan
    carry (one residual stream per layer block) is the dominant stored
    activation under full remat."""
    cfg = get_config(arch)
    big_moe = cfg.param_count() > 100e9
    shape = shape or SHAPES_BY_NAME["train_4k"]
    # Non-MoE archs train in zero3 mode (weights fully sharded over every
    # mesh axis, batch data-parallel over every axis, no per-layer
    # activation collectives): validated 10.8x collective reduction on
    # granite-20b train_4k (EXPERIMENTS.md §Perf-A). MoE archs keep
    # fsdp_tp — the expert banks need the `model` axis for EP. Untied
    # >=200k vocabs also keep fsdp_tp: XLA materialises the full f32
    # unembed gradient before its reduce-scatter under zero3 (nemotron:
    # 23 GiB/chip — §Perf-A follow-up, open XLA cost-model issue).
    zero3 = (cfg.num_experts == 0
             and not (cfg.vocab_size >= 200_000 and not cfg.tie_embeddings))
    tokens = shape.global_batch * shape.seq_len
    microbatches = 1
    if not zero3:
        while (tokens // microbatches > 131_072
               and microbatches < shape.global_batch
               and shape.global_batch % (microbatches * 2) == 0):
            microbatches *= 2
        if big_moe and shape.global_batch % (microbatches * 2) == 0:
            microbatches *= 2   # headroom for expert buckets + bf16 states
    return TrainConfig(
        opt_state_dtype="bfloat16" if big_moe else "float32",
        grad_acc_dtype="bfloat16" if big_moe else "float32",
        microbatches=microbatches,
        remat="full",
        sharding_mode="zero3" if zero3 else "fsdp_tp",
        loss_chunk=512 if cfg.vocab_size >= 49152 else 0,
    )


def make_run_config(arch: str, shape: str, multi_pod: bool = False) -> RunConfig:
    mesh = MeshConfig(
        shape=(2, 16, 16) if multi_pod else (16, 16),
        axes=("pod", "data", "model") if multi_pod else ("data", "model"),
    )
    cfg = get_config(arch)
    # context-parallel prefill for the dense families: validated 7.3x
    # collective reduction on llama3-8b prefill_32k (§Perf-B)
    seq_par = cfg.family in ("dense", "vlm", "audio")
    return RunConfig(
        model=cfg,
        shape=SHAPES_BY_NAME[shape],
        mesh=mesh,
        train=default_train_config(arch, SHAPES_BY_NAME[shape]),
        serve=ServeConfig(seq_parallel=seq_par),
    )


__all__ = [
    "ASSIGNED_ARCHS",
    "SUBQUADRATIC_ARCHS",
    "MeshConfig",
    "ModelConfig",
    "RunConfig",
    "ServeConfig",
    "ShapeConfig",
    "SHAPES",
    "SHAPES_BY_NAME",
    "TrainConfig",
    "default_train_config",
    "get_config",
    "get_reduced_config",
    "list_archs",
    "make_run_config",
    "reduced",
    "shape_cells",
]
