"""Serving step factories — the serve half of ``repro.launch.steps``.

``make_prefill_step`` and ``make_decode_step`` close over the static
config and return functions of (model, data), as the reference's do for
its launchers. One device: a ``mesh`` other than None is refused (the
sharded LM is ROADMAP A13c), and the train half (``make_train_step``,
``TrainState``) is A13b.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.models import lm


def _one_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the port's LM runs on one device; a mesh (sharded prefill and "
            "decode, ParallelCtx's modes) is ROADMAP A13c")


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
