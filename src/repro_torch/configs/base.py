"""Model configuration — the part of ``repro.configs.base`` the port runs.

``ModelConfig`` keeps the reference's field names, defaults and the
properties the ViT feature extractor reads (``resolved_head_dim``,
``q_dim``). The LM families' fields (MoE, SSM, hybrid, RoPE) and the
shape, mesh, train and serve configs come with the LM scaffolding
(ROADMAP A13).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. The ViT reads ``num_layers``,
    ``d_model``, ``num_heads``, ``head_dim``, ``d_ff`` and ``norm_eps``;
    it computes in float32 whatever ``compute_dtype`` says, as the
    reference's ViT does."""

    name: str
    family: str
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0            # 0 -> d_model // num_heads
    d_ff: int = 0
    mlp_activation: str = "silu"   # silu | gelu | relu2
    mlp_gated: bool = True          # False -> classic 2-matmul MLP
    input_mode: str = "tokens"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim
