"""internlm2-1.8b — dense, GQA kv=8, llama-style gated SiLU. [arXiv:2403.17297; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    mlp_activation="silu",
    mlp_gated=True,
    vocab_size=92544,
    source="arXiv:2403.17297; hf",
)
