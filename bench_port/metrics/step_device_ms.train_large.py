"""step_device_ms.train_large: `layers.step_device_ms`, read in the large-batch training cells."""

from bench_port.layers import step_device_ms as read  # noqa: F401
