"""Process-group start-up (counterpart of
`semantichuman_tpu/parallel/distributed.py`).

The JAX package spans one data mesh over every process's devices and lets
XLA insert the gradient psum.  The port runs one process per card instead:
`initialize_distributed` joins the process group (NCCL on the card, gloo for
the CPU), and rank r owns rows [r*per, (r+1)*per) of every global batch
(`process_local_batch_slice`), as in the JAX contract.

    torchrun --nproc_per_node N -m semantichuman_torch.cli.train \
        --distributed ...        # env://: MASTER_ADDR, RANK, WORLD_SIZE
    python -m semantichuman_torch.cli.train --distributed \
        --coordinator tcp://host:port --num_processes N --process_id R ...
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None,
                           device: str = "cuda") -> None:
    """Join the process group: from explicit arguments (`tcp://host:port`,
    or `host:port`) or from torchrun's environment (`env://`).  The backend
    is NCCL for device 'cuda' and gloo for 'cpu' unless `backend` names
    one.  On the card the process's device becomes cuda:LOCAL_RANK (torchrun
    sets it; else the rank modulo the cards on the host).

    A second call is a no-op.  With no argument and no torchrun environment
    the process stays alone (world size 1, no group); an explicit request
    whose group cannot form raises."""
    if dist.is_initialized():
        return
    explicit = coordinator_address or os.environ.get("MASTER_ADDR")
    if not explicit and num_processes is None:
        return
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and "
                             "--process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        rank, world = process_id, num_processes
    else:
        url = "env://"
        rank = int(os.environ.get("RANK", process_id or 0))
        world = int(os.environ.get("WORLD_SIZE", num_processes or 1))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("distributed training on 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=url, world_size=world,
                            rank=rank)


def process_count() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_local_batch_slice(global_batch: int) -> tuple[int, int]:
    """(start, size) of this process's rows of a global batch: rank r owns
    rows [r*per, (r+1)*per), the contract `BatchLoader(process_slice=...)`
    keeps."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    per = global_batch // n
    return process_index() * per, per
