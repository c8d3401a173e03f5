"""Feature extraction: the ViT-T extractor and the catalog pass."""
