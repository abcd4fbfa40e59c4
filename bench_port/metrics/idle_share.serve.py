"""idle_share.serve: `layers.idle_share`, read in the serving cells."""

from bench_port.layers import idle_share as read  # noqa: F401
