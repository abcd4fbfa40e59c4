"""Hand-written CUDA kernels: sources in `semantichuman_torch/csrc/`, built
with nvcc on first use (see build.py).

`LIB` holds the `semantichuman` namespace of custom operators through which
the exported programs, training and serving reach the kernels (the conv
forward in `ops/spiral_conv.py`, the row gather in `ops/row_gather.py`):
defining one builds and loads nothing."""

import torch

LIB = torch.library.Library("semantichuman", "DEF")
