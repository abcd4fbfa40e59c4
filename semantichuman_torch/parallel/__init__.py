"""Data parallelism over torch.distributed (the port's counterpart of
`semantichuman_tpu/parallel/`): one process per card, each training on its
own contiguous slice of every global batch, the parameters replicated and
the gradient all-reduced explicitly."""
