"""granite-20b — dense code LM, MQA (kv=1), 52L. [arXiv:2405.04324; hf]

Note: the 20B total requires the GPT-BigCode-style *ungated* MLP (2 matmuls);
a gated reading of d_ff=24576 would give ~28B. Recorded in DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    mlp_activation="gelu",
    mlp_gated=False,
    vocab_size=49152,
    param_dtype="bfloat16",
    source="arXiv:2405.04324; hf",
)
