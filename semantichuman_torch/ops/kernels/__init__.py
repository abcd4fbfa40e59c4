"""Hand-written CUDA kernels: sources in `semantichuman_torch/csrc/`, built
with nvcc on first use (see build.py)."""
