"""Shape-and-dtype stand-ins for every model input — counterpart of
``repro.launch.specs``.

The reference's currency is ``jax.ShapeDtypeStruct`` and ``eval_shape``;
the port's is tensors on the ``meta`` device: ``input_specs(arch,
shape)`` returns exactly what the corresponding step function takes
(shapes and dtypes), and never allocates device memory. The parameters
are a meta-device ``LM`` (one tensor a layer; ``sharding.reference_leaf``
maps each to the reference's block-stacked leaf), the decode caches a
meta-device ``lm.init_caches``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import (SHAPES_BY_NAME, ModelConfig,
                                      ServeConfig, ShapeConfig)
from repro_torch.models import lm

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype``: the port's
    ``ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    if cfg.input_mode == "embeddings":
        inputs = sds((b, s, cfg.d_model), torch.bfloat16)
    else:
        inputs = sds((b, s), torch.int32)
    return {"inputs": inputs, "targets": sds((b, s), torch.int32)}


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[Any, ...]:
    b, s = shape.global_batch, shape.seq_len
    if cfg.input_mode == "embeddings":
        return (sds((b, s, cfg.d_model), torch.bfloat16),)
    return (sds((b, s), torch.int32),)


def decode_specs(cfg: ModelConfig, shape: ShapeConfig,
                 serve: ServeConfig = ServeConfig()) -> Tuple[Any, ...]:
    """(caches, token, pos) for decode_step; one new token against a
    seq_len-deep context."""
    b, s = shape.global_batch, shape.seq_len
    caches = lm.init_caches(cfg, b, s, serve, device=META)
    return caches, sds((b, 1), torch.int32), sds((), torch.int32)


def params_specs(cfg: ModelConfig) -> lm.LM:
    """The model on the meta device: every parameter's shape and dtype,
    nothing allocated."""
    return lm.LM(cfg, device=META)


def input_specs(arch: str, shape_name: str,
                serve: ServeConfig = ServeConfig()) -> Dict[str, Any]:
    """Everything a dry run needs for one (arch x shape) cell."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    out: Dict[str, Any] = {"model": cfg, "shape": shape,
                           "params": params_specs(cfg)}
    if shape.kind == "train":
        out["batch"] = train_batch_specs(cfg, shape)
    elif shape.kind == "prefill":
        out["args"] = prefill_specs(cfg, shape)
    else:
        out["args"] = decode_specs(cfg, shape, serve)
    return out
