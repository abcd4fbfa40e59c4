"""Device ops: `spiral_conv` (CUDA kernel beside its plain PyTorch version)
and `sampling` (mesh pool/unpool)."""
