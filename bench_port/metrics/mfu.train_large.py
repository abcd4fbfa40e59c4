"""mfu.train_large: `layers.mfu_train`, read in the large-batch training cells."""

from bench_port.layers import mfu_train as read  # noqa: F401
