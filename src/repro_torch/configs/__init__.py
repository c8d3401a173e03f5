"""Config registry of the port: ``get_config("rapidearth-vit-t")``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

PORTED_ARCHS = ("rapidearth-vit-t",)


def get_config(arch: str) -> ModelConfig:
    """The ported architecture's config; any other arch id raises (the LM
    configs come with ROADMAP A13)."""
    if arch == "rapidearth-vit-t":
        from repro_torch.configs.rapidearth_vit import CONFIG
        return CONFIG
    raise NotImplementedError(
        f"arch {arch!r} is not ported to repro_torch (the LM configs are "
        f"ROADMAP A13); ported: {list(PORTED_ARCHS)}")


__all__ = ["ModelConfig", "PORTED_ARCHS", "get_config"]
