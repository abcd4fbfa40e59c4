"""idle_share.n3dmm: `layers.idle_share`, read in the neural3DMM training cells."""

from bench_port.layers import idle_share as read  # noqa: F401
