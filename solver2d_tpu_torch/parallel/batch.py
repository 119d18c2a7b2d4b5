"""World batches: a leading worlds dim on every tensor of the state.

An own copy of the JAX package's `parallel/batch.py`: one batch of worlds
is one state with a leading axis, stepped by one call.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import SimConfig
from ..state import State
from ..step import step


def replicate(state: State, n: int) -> State:
    """Tile one world into an [n, ...] batch (fresh memory)."""
    return state.map(lambda x: x[None].expand((n,) + tuple(x.shape)).contiguous())


# the JAX package's name
replicate_state = replicate


def batch_states(states: list[State]) -> State:
    """Stack same-capacity worlds into a [W, ...] batch."""
    return states[0].map(lambda *xs: torch.stack(xs), *states[1:])


def batched_step(config: SimConfig):
    """Returns step(batch, dt) -> batch: the per-world step (each world with
    its own pairs, colors and fused solve) on an [W, ...] batch; the
    counterpart of the JAX package's vmapped `step`."""

    def run(batch: State, dt: float) -> State:
        return step(batch, dt, config)

    return run


def apply_velocity_deltas(batch: State, dv, dw) -> State:
    """The batch with dv [W, B, 2] and dw [W, B] added to the velocities of
    its live dynamic bodies."""
    b = batch.bodies
    dyn = (b.type == 2) & b.alive
    bodies = dataclasses.replace(
        b,
        v=torch.where(dyn[..., None], b.v + dv.to(b.v.device), b.v),
        w=torch.where(dyn, b.w + dw.to(b.w.device), b.w),
    )
    return dataclasses.replace(batch, bodies=bodies)


def randomize_velocities(batch: State, generator: torch.Generator, scale=0.5) -> State:
    """Per-world initial-condition jitter (diversity for RL-style rollouts):
    every live dynamic body's velocities plus scale * N(0, 1), drawn from
    `generator` (on its device). The draws are PyTorch's, not the JAX
    package's `jax.random`; `apply_velocity_deltas` applies given ones."""
    n, nb = batch.bodies.v.shape[:2]
    dev = generator.device
    dv = scale * torch.randn((n, nb, 2), generator=generator, device=dev, dtype=torch.float32)
    dw = scale * torch.randn((n, nb), generator=generator, device=dev, dtype=torch.float32)
    return apply_velocity_deltas(batch, dv, dw)
