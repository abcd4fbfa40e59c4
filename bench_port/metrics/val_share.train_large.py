"""val_share.train_large: `layers.val_share`, read in the large-batch training cells."""

from bench_port.layers import val_share as read  # noqa: F401
