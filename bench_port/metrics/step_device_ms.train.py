"""step_device_ms.train: `layers.step_device_ms`, read in the small-batch training cells."""

from bench_port.layers import step_device_ms as read  # noqa: F401
