"""conv_fwd_roofline.train_large: `layers.conv_fwd_roofline_train`, read in the large-batch training cells."""

from bench_port.layers import conv_fwd_roofline_train as read  # noqa: F401
