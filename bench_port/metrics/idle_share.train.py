"""idle_share.train: `layers.idle_share`, read in the small-batch training cells."""

from bench_port.layers import idle_share as read  # noqa: F401
