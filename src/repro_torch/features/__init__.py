"""Feature extraction and the extractor's training: the ViT-T extractor,
the catalog pass and DINO (counterpart of ``repro.features``)."""
from repro_torch.features.dino import DinoState, init_dino, make_dino_step
from repro_torch.features.extract import (extract_catalog,
                                          extraction_throughput,
                                          lm_feature_fn, vit_feature_fn)
from repro_torch.features.vit import extract_features, init_vit, vit_forward

__all__ = [
    "DinoState", "extract_catalog", "extract_features",
    "extraction_throughput", "init_dino", "init_vit", "lm_feature_fn",
    "make_dino_step", "vit_feature_fn", "vit_forward",
]
