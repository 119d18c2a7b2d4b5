"""Worlds split over devices: each entry of a mesh steps its own block of
the world batch.

An own copy of the JAX package's `parallel/sharding.py` API. Worlds are
independent (reference: src/world.c:29-45), so the split is pure data
parallelism over the worlds dim, the layout of the JAX package's
`NamedSharding(mesh, P('worlds'))`: dim 0 cut into equal contiguous
blocks, one per mesh entry, each on its device. A step runs each block on
its own CUDA stream under its device, with no collectives; only a metric
reduction across processes (`metrics_psum_example`) communicates.

A device may be listed more than once: each entry is one shard with its
own stream, so that one card can hold several shards (the JAX package's
tests shard over 8 virtual CPU devices the same way). The per-world step
syncs with the host in its coloring, so shards driven from one Python
thread run one after another.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..config import SimConfig
from ..state import State
from ..step import step, step_batch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of this process, one shard each, along one named axis;
    the process group of a multi-process run (`distributed.initialize`),
    else None; a CUDA stream per CUDA entry (None on the CPU)."""

    devices: tuple
    axis: str = "worlds"
    group: Optional[object] = None
    streams: tuple = ()

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None, axis: str = "worlds") -> Mesh:
    """A mesh over `devices` (default: every CUDA device this process
    sees), with this process's group once `distributed.initialize` has
    run. A device may appear more than once."""
    if devices is None:
        if not torch.cuda.is_available():
            raise ValueError("make_mesh: no CUDA device; pass devices (for example ['cpu'] * 2)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: no devices")
    streams = tuple(torch.cuda.Stream(d) if d.type == "cuda" else None for d in devices)
    dist = torch.distributed
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    return Mesh(devices, axis, group, streams)


@dataclasses.dataclass
class ShardedState:
    """A world batch split over a mesh: `shards[i]` holds the i-th block of
    worlds on `mesh.devices[i]`. `offset` is the global index of this
    process's first world and `global_worlds` the worlds of every process."""

    shards: list
    mesh: Mesh
    offset: int = 0
    global_worlds: Optional[int] = None

    @property
    def local_worlds(self) -> int:
        return sum(s.bodies.type.shape[0] for s in self.shards)

    def gather(self, device=None) -> State:
        """This process's worlds as one [W, ...] batch on `device` (default
        the first entry's), in order, after every shard's stream."""
        device = torch.device(device) if device is not None else self.mesh.devices[0]
        for dev, stream in zip(self.mesh.devices, self.mesh.streams):
            if stream is not None:
                torch.cuda.current_stream(dev).wait_stream(stream)
        parts = [s.to(device) for s in self.shards]
        return parts[0].map(lambda *xs: torch.cat(xs), *parts[1:])


def shard_state(batch: State, mesh: Mesh, axis: str = "worlds") -> ShardedState:
    """Split a [W, ...] batch into mesh.size equal contiguous blocks of
    worlds, a copy of each on its entry's device."""
    n = batch.bodies.type.shape[0]
    if n % mesh.size:
        raise ValueError(f"shard_state: {n} worlds do not split evenly over {mesh.size} mesh entries")
    per = n // mesh.size
    shards = []
    for i, dev in enumerate(mesh.devices):
        shards.append(batch.map(lambda x: x[i * per:(i + 1) * per].to(dev, copy=True)))
    return ShardedState(shards, mesh, 0, n)


def _on_shards(mesh: Mesh, fn, shards):
    """fn(shard) for each entry, under its device and on its stream; each
    stream waits for its device's current stream first, and the current
    streams wait for the shards' streams after."""
    outs = []
    for dev, stream, shard in zip(mesh.devices, mesh.streams, shards):
        if stream is None:
            outs.append(fn(shard))
            continue
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            outs.append(fn(shard))
    for dev, stream in zip(mesh.devices, mesh.streams):
        if stream is not None:
            torch.cuda.current_stream(dev).wait_stream(stream)
    return outs


def sharded_step(config: SimConfig, mesh: Mesh, axis: str = "worlds"):
    """step(batch, dt) -> ShardedState over `mesh`. A plain `State` is
    sharded first (`shard_state`). Under `config.lane_solve` each shard runs
    the lane step (`step_batch`) on its local worlds, with the structure of
    its local world 0 (exact for lockstep batches, as the JAX package's
    `shard_map`); otherwise each shard runs the per-world `step` on the
    route `World.freeze` picked."""
    fn = step_batch if config.lane_solve else step

    def run(batch: Union[State, ShardedState], dt: float) -> ShardedState:
        if isinstance(batch, State):
            batch = shard_state(batch, mesh, axis)
        if batch.mesh.devices != mesh.devices:
            raise ValueError("sharded_step: the batch is sharded over another mesh")
        shards = _on_shards(mesh, lambda s: fn(s, dt, config), batch.shards)
        return dataclasses.replace(batch, shards=shards, mesh=mesh)

    return run


def metrics_psum_example(batch: Union[State, ShardedState], mesh: Mesh, axis: str = "worlds"):
    """The one reduction across shards: 0.5 * sum(v**2) of each shard's
    body velocities, the shard sums added in mesh order on the first
    entry's device, then summed over the processes of `mesh.group` (an
    all_reduce) when the mesh has one. A 0-dim float32 tensor."""
    if isinstance(batch, State):
        batch = shard_state(batch, mesh, axis)
    local = _on_shards(mesh, lambda s: 0.5 * torch.sum(s.bodies.v ** 2), batch.shards)
    total = local[0].to(mesh.devices[0])
    for x in local[1:]:
        total = total + x.to(mesh.devices[0])
    if mesh.group is not None:
        torch.distributed.all_reduce(total, group=mesh.group)
    return total
