"""nemotron-4-15b — dense, GQA kv=8, squared-ReLU ungated MLP. [arXiv:2402.16819]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    mlp_activation="relu2",
    mlp_gated=False,
    vocab_size=256000,
    param_dtype="bfloat16",
    source="arXiv:2402.16819; unverified",
)
