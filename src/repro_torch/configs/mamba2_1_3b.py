"""mamba2-1.3b — attention-free SSD (state-space duality). [arXiv:2405.21060]

48 SSD blocks, d_model=2048, expand=2 (d_inner=4096), head_dim=64 (64 heads),
state=128. Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_conv_width=4,
    source="arXiv:2405.21060; unverified",
)
