"""The paper's own feature extractor: ViT-T/16 (counterpart of
``repro.configs.rapidearth_vit``).

RapidEarth trains a ViT-T (12L, d=192, 3 heads, d_ff=768) with DINO on
400k aerial patches and extracts 384 features per patch: the CLS token
concatenated with the mean-pooled patch tokens of the 192-d trunk. This
config drives ``features/vit.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rapidearth-vit-t",
    family="vit",
    num_layers=12,
    d_model=192,
    num_heads=3,
    num_kv_heads=3,
    head_dim=64,
    d_ff=768,
    mlp_activation="gelu",
    mlp_gated=False,
    vocab_size=0,
    input_mode="images",
    source="paper §3 (ViT-T + DINO, 384 features/patch)",
)

# Feature dimensionality the search engine indexes (paper §3).
FEATURE_DIM = 384
PATCH_SIZE = 16
IMAGE_SIZE = 64   # reduced stand-in for the 400x400 patches (see DESIGN.md)
