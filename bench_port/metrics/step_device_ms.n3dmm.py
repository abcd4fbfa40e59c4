"""step_device_ms.n3dmm: `layers.step_device_ms`, read in the neural3DMM training cells."""

from bench_port.layers import step_device_ms as read  # noqa: F401
