"""mfu.n3dmm: `layers.mfu_train`, read in the neural3DMM training cells
(the two dense layers counted at the trunk batch)."""

from bench_port.layers import mfu_train as read  # noqa: F401
