"""idle_share.train_large: `layers.idle_share`, read in the large-batch training cells."""

from bench_port.layers import idle_share as read  # noqa: F401
