"""Data parallelism over torch.distributed (the port's counterpart of
`semantichuman_tpu/parallel/`): one process per card, each training on its
own contiguous slice of every global batch, the parameters replicated and
the gradient all-reduced explicitly."""

from .distributed import (initialize_distributed,  # noqa: F401
                          process_local_batch_slice)
from .mesh import (all_reduce_grads, fully_replicate,  # noqa: F401
                   put_replicated, shard_batch)
