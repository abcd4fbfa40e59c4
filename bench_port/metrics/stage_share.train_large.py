"""stage_share.train_large: `stage_share.train`'s reading in the
large-batch training cells."""

from bench_port.manifest import metric_reader

read = metric_reader("stage_share.train")
