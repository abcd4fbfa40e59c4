"""conv_fwd_roofline.serve: `layers.conv_fwd_roofline_serve`, read in the serving cells."""

from bench_port.layers import conv_fwd_roofline_serve as read  # noqa: F401
