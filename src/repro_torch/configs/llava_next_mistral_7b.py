"""llava-next-mistral-7b — VLM: mistral-7b backbone, anyres-tiling frontend.

The modality frontend (CLIP vision tower + anyres tiling + projector) is a
STUB per the assignment: ``input_specs()`` supplies precomputed patch
embeddings of width d_model. Only the transformer backbone is modelled.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    mlp_activation="silu",
    mlp_gated=True,
    vocab_size=32000,
    input_mode="embeddings",
    param_dtype="bfloat16",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
