"""mfu.train: `layers.mfu_train`, read in the small-batch training cells."""

from bench_port.layers import mfu_train as read  # noqa: F401
