"""repro_torch — the RapidEarth engine on PyTorch and CUDA (NVIDIA H100).

A port of the ``repro`` JAX package, slice by slice (ROADMAP.md). It
imports ``torch`` and numpy, never JAX or ``repro``. Entry points run on
CUDA unless given ``device="cpu"``.
"""
