"""llama4-maverick-400b-a17b — MoE 128e top-1, early fusion.

Assumption (recorded in DESIGN.md §Arch-applicability): MoE layers are
interleaved every 2nd layer (moe_period=2) with one shared expert, which
reproduces the ~400B-total / ~17B-active figures; a flat 48x128-expert
reading gives 773B, inconsistent with the model name.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    mlp_activation="silu",
    mlp_gated=True,
    vocab_size=202048,
    num_experts=128,
    experts_per_token=1,
    num_shared_experts=1,
    moe_period=2,
    param_dtype="bfloat16",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
