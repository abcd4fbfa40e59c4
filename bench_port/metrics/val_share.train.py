"""val_share.train: `layers.val_share`, read in the small-batch training cells."""

from bench_port.layers import val_share as read  # noqa: F401
