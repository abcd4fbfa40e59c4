"""mfu.serve: `layers.mfu_serve`, read in the serving cells."""

from bench_port.layers import mfu_serve as read  # noqa: F401
