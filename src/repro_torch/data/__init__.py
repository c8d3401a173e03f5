"""Synthetic patch data and the data pipeline (numpy copies of the
reference's). Exports what ``repro.data`` exports."""
from repro_torch.data.pipeline import (DataConfig, PatchSource, Prefetcher,
                                       TokenSource)
from repro_torch.data.synthetic import (CLASSES, CLASS_IDS,
                                        PatchDatasetConfig, generate_patches,
                                        handcrafted_features)

__all__ = [
    "CLASSES", "CLASS_IDS", "DataConfig", "PatchDatasetConfig", "PatchSource",
    "Prefetcher", "TokenSource", "generate_patches", "handcrafted_features",
]
