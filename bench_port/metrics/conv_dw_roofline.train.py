"""conv_dw_roofline.train: `layers.conv_dw_roofline_train`, read in the small-batch training cells."""

from bench_port.layers import conv_dw_roofline_train as read  # noqa: F401
