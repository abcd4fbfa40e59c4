"""val_share.n3dmm: `layers.val_share`, read in the neural3DMM training cells."""

from bench_port.layers import val_share as read  # noqa: F401
