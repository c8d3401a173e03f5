"""qwen3-moe-235b-a22b — MoE 128 experts top-8, every layer. [hf:Qwen/Qwen3-30B-A3B]

94L, d_model=4096, 64 q heads / 4 kv heads (head_dim=128 explicit), expert
d_ff=1536. Analytic totals: ~235B params, ~22B active.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    mlp_activation="silu",
    mlp_gated=True,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    moe_period=1,
    param_dtype="bfloat16",
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
