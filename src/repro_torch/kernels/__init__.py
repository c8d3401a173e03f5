"""Hand-written CUDA kernels of the main path, their plain PyTorch
versions and the device ops built on them."""
