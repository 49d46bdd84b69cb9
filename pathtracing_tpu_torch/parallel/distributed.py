"""Process-group bring-up for multi-GPU and multi-host rendering
(counterpart of pathtracing_tpu/parallel/distributed.py).

    # on every rank (torchrun sets RANK, WORLD_SIZE, MASTER_ADDR/PORT):
    from pathtracing_tpu_torch.parallel.distributed import initialize
    initialize()                      # env:// by default
    mesh = make_mesh()                # spans every rank of the group
    film = render_sharded(scene, cam, meta, cfg, mesh=mesh)

Every rank builds the identical scene (host-side builds are
deterministic); `render_sharded` and `train_step_sharded` all-reduce the
film or the gradients, so every rank holds the result.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None):
    """torch.distributed.init_process_group.  coordinator_address
    ("host:port") makes it tcp://host:port with num_processes ranks, this
    one process_id; without it the group comes from the environment
    (env://).  backend: "nccl" when CUDA is available, else "gloo"; with
    nccl each rank takes the GPU LOCAL_RANK (else rank modulo the GPUs it
    sees) as its current device."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    rank = dist.get_rank()
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    world = dist.get_world_size()
    return dict(process_index=rank, process_count=world, local_devices=1,
                global_devices=world)


def is_coordinator() -> bool:
    """Rank 0 of the process group (True without one)."""
    return not dist.is_initialized() or dist.get_rank() == 0
