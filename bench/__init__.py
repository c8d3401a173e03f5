"""The benchmark of the PyTorch / CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once (``bench/run.py``);
configurations, traffic mixes and per-layer metrics are files found by
name (``bench/registry.py``). See ``bench/README.md``.
"""
