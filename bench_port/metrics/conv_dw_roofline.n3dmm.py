"""conv_dw_roofline.n3dmm: `layers.conv_dw_roofline_train`, read in the neural3DMM training cells."""

from bench_port.layers import conv_dw_roofline_train as read  # noqa: F401
