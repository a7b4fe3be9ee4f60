"""Process-group bring-up and the mesh over every rank (counterpart of
tpu_multigrid/parallel/multihost.py).

`initialize` wires torch.distributed from torchrun's environment
(`torchrun --nproc-per-node=4 -m tpu_multigrid_torch.cli --mesh 2,2 ...`)
or from an explicit init method, and `global_mesh` builds the ('x', 'y')
lattice mesh over all ranks, so the SPMD solver of parallel/sharded.py
runs unchanged on one host or several. NCCL carries CUDA tensors (rank r
on cuda:LOCAL_RANK), gloo CPU ones. A process-group timeout makes a lost
rank raise instead of hang.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .sharded import Mesh, make_mesh

TIMEOUT_S = 300.0


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = TIMEOUT_S) -> bool:
    """Initialize the default process group where there is one to join.
    Returns True if distributed mode is active.

    init_method (e.g. 'tcp://localhost:29500' or 'file:///path') with
    world_size and rank joins that group; without it, torchrun's
    environment (WORLD_SIZE, RANK, MASTER_ADDR, ...) is read, and
    world_size=1 with no such environment makes a one-rank group in this
    process. Otherwise nothing is done and False returned. backend: 'nccl'
    (default: the card; with torchrun the process takes
    cuda:LOCAL_RANK) or 'gloo' (CPU tensors). A failure raises."""
    if dist.is_initialized():
        return True
    backend = backend or "nccl"
    timeout = datetime.timedelta(seconds=timeout_s)
    env = "WORLD_SIZE" in os.environ
    if backend == "nccl" and (init_method is not None or env):
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank,
                                timeout=timeout)
    elif env:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    elif world_size == 1:
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0, timeout=timeout)
    else:
        return False
    return True


def mesh_shape_for(n_devices: int) -> Tuple[int, int]:
    """Near-square 2D factorization."""
    mx = int(np.floor(np.sqrt(n_devices)))
    while n_devices % mx:
        mx -= 1
    return mx, n_devices // mx


def global_mesh(shape: Optional[Tuple[int, int]] = None,
                device=None) -> Mesh:
    """('x', 'y') mesh over every rank of the default group."""
    if shape is None:
        shape = mesh_shape_for(dist.get_world_size())
    return make_mesh(shape, device)


def is_coordinator() -> bool:
    """Rank 0, or a process outside any group."""
    return not dist.is_initialized() or dist.get_rank() == 0
