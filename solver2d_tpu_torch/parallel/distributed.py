"""Several processes, each stepping its own block of a global world batch.

An own copy of the JAX package's `parallel/distributed.py` API. Worlds are
independent (reference: src/world.c:29-45), so a multi-process run is pure
data parallelism: `initialize` joins this process to a `torch.distributed`
process group, each process builds its mesh of local devices
(`make_mesh`, which takes the group in), and `global_batch` materialises
only this process's worlds. The step itself communicates nothing; only a
metric reduction (`sharding.metrics_psum_example`) does, an all_reduce
over NCCL on the card or gloo on the CPU.

Usage (the same script in every process, rank r of n):

    initialize("tcp://host:port", n, r)     # or "file:///shared/path"
    mesh = make_mesh()                      # this process's devices
    batch = global_batch(state, worlds_per_chip=512, mesh=mesh)
    stepf = sharded_step(config, mesh)
"""

from __future__ import annotations

from typing import Optional

import torch

from .batch import replicate
from .sharding import Mesh, ShardedState, make_mesh, shard_state, sharded_step  # noqa: F401


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None):
    """Join the process group of a multi-process run: `init_process_group`
    with `coordinator_address` as its init method (`tcp://host:port`, a bare
    `host:port`, or `file://path`), num_processes ranks and this process's
    rank, over NCCL where CUDA is available, else gloo. A no-op for a
    single process given no address, as in the JAX package."""
    if num_processes in (None, 1) and coordinator_address is None:
        return
    if coordinator_address is None:
        raise ValueError("initialize: several processes need a coordinator address")
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    torch.distributed.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo", init_method=coordinator_address,
        world_size=num_processes or 1, rank=process_id or 0,
    )


def global_batch(state, worlds_per_chip: int, mesh: Optional[Mesh] = None) -> ShardedState:
    """A global batch of identical copies of one world (`state`, no worlds
    dim): worlds_per_chip on each entry of this process's mesh. Rank r of
    the process group holds global worlds [r * L, (r + 1) * L), L its local
    world count; only those are made here."""
    mesh = mesh if mesh is not None else make_mesh()
    local = worlds_per_chip * mesh.size
    dist = torch.distributed
    rank, ranks = 0, 1
    if mesh.group is not None:
        rank, ranks = dist.get_rank(mesh.group), dist.get_world_size(mesh.group)
    shards = [replicate(state.to(dev), worlds_per_chip) for dev in mesh.devices]
    return ShardedState(shards, mesh, rank * local, ranks * local)
