"""stage_share.n3dmm: `stage_share.train`'s reading in the neural3DMM
training cells."""

from bench_port.manifest import metric_reader

read = metric_reader("stage_share.train")
