"""conv_dx_roofline.n3dmm: `conv_dx_roofline.train_large`'s reading in the
neural3DMM training cells (silent where the step is not replayed from a
captured graph)."""

from bench_port.manifest import metric_reader

read = metric_reader("conv_dx_roofline.train_large")
