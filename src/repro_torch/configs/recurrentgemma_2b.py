"""recurrentgemma-2b — hybrid RG-LRU + local attention, 1:2. [arXiv:2402.19427; hf]

26 layers; every 3rd layer (i % 3 == 2) is local sliding-window attention
(window 2048, MQA kv=1), the rest are RG-LRU recurrent blocks.
Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    mlp_activation="gelu",
    mlp_gated=True,
    vocab_size=256000,
    attn_period=3,
    local_window=2048,
    lru_width=2560,
    tie_embeddings=True,
    scale_embed=True,
    source="arXiv:2402.19427; hf",
)
