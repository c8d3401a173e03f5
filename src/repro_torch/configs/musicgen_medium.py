"""musicgen-medium — decoder-only over EnCodec tokens, MHA (kv=24).

The EnCodec audio frontend is a STUB per the assignment: the backbone
consumes codebook token ids (vocab 2048); ``input_specs()`` provides them
directly (delay-pattern interleaving collapses to a single token stream).
[arXiv:2306.05284; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    mlp_activation="gelu",
    mlp_gated=False,
    vocab_size=2048,
    pos_embed="sinusoidal",
    source="arXiv:2306.05284; hf",
)
