"""conv_fwd_roofline.train: `layers.conv_fwd_roofline_train`, read in the small-batch training cells."""

from bench_port.layers import conv_fwd_roofline_train as read  # noqa: F401
