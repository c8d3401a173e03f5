"""repro_torch — the RapidEarth engine on PyTorch and CUDA (NVIDIA H100).

A port of the ``repro`` JAX package, slice by slice (ROADMAP.md). It
imports ``torch`` and numpy, never JAX or ``repro``. Entry points run on
CUDA unless given ``device="cpu"``:

- ``core.SearchEngine``: the search engine (``query``, ``query_batch``);
- ``features.vit.init_vit`` / ``core.convert.vit_from_numpy``: the ViT-T
  feature extractor, from a seed or from a reference parameter tree;
- ``features.extract.extract_catalog``: patches -> [N, 384] features;
- ``data.synthetic.generate_patches``: the synthetic patch catalog.
"""
